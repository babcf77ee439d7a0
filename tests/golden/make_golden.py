#!/usr/bin/env python3
"""Generate the committed golden fixtures for the five BASELINE configs.

Inputs are deterministic committed files (written by this script the first
time); golden ``.lib``/``.pairs`` outputs are produced by the **scalar NumPy
mirror** (``--backend reference``), the project's executable spec of the
reference binary (the real binary is unbuildable here: empty vendored
submodules -- see PARITY_AUDIT.md).  The test suite then locks BOTH backends
to these bytes, so any regression in either the mirror or the device solver
is caught against a frozen artifact rather than self-referentially.

Run from the repo root:  python tests/golden/make_golden.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _write(path: str, text: str) -> None:
    with open(os.path.join(HERE, path), "w") as handle:
        handle.write(text)


def make_inputs() -> None:
    # -- config 1: single short pair, fixed dot-bracket structures ---------
    _write("cfg1_pair.dbn",
           ">hairpinA\nGGGGCAAUAGCCCC\n((((......))))\n"
           ">hairpinB\nGGGCAAAAAGCCC\n(((.......)))\n")

    # -- config 2: base-pair probability input (ebpseq dialect) ------------
    # soft, partially conflicting partner candidates drive the full loop
    rng = np.random.default_rng(11)
    seqs = ["GGGCGCAAGCCUUAAGGCGCUC", "GGGCGUAAGCCUUCAGGCGCCC",
            "GGCCGCAAGCCUAAAGGCGGCC"]
    lines = ["## S1: bpp_a", "## S2: bpp_b", "## S3: bpp_c"]
    for sid, seq in enumerate(seqs, 1):
        lines.append(f"# S{sid} M{sid}")
        length = len(seq)
        for pos in range(length):
            partners = []
            for off in (9, 11, 13):
                partner = pos + off
                if partner < length:
                    prob = round(float(rng.uniform(0.06, 0.9)), 3)
                    partners.append(f"{prob}/{partner + 1}")
            cell = ",".join(partners) if partners else "-"
            lines.append(f"{pos + 1} {seq[pos]} {cell}")
    _write("cfg2_bpp.ebpseq", "\n".join(lines) + "\n")

    # -- config 3: all-pairs family from Stockholm -------------------------
    rng = np.random.default_rng(23)
    base = "GGGCGCAAGCCUUAAGGCGCCCAAGGCUUAGC"
    cons = "(((((((......)))))))....((...))."
    rows = []
    for k in range(8):
        seq = list(base)
        for _ in range(int(rng.integers(1, 5))):
            seq[int(rng.integers(0, len(seq)))] = "ACGU"[rng.integers(0, 4)]
        rows.append((f"fam{k}", "".join(seq)))
    sth = ["# STOCKHOLM 1.0"]
    for name, seq in rows:
        sth.append(f"{name:<14}{seq}")
    sth.append(f"{'#=GC SS_cons':<14}{cons}")
    sth.append("//")
    _write("cfg3_family.sth", "\n".join(sth) + "\n")

    # -- config 4: long pair (16S-scale) with sparse dotplot-style bpp -----
    rng = np.random.default_rng(47)
    length = 1200
    stems = []
    pos = 10
    while pos + 120 < length:  # nested stems marching down the molecule
        span = int(rng.integers(60, 110))
        n_bp = int(rng.integers(6, 12))
        for k in range(n_bp):
            stems.append((pos + k, pos + span - k))
        pos += span + int(rng.integers(10, 30))
    bases = "ACGU"
    comp = {"A": "U", "C": "G", "G": "C", "U": "A"}
    for _seq_id in range(2):
        seq = [bases[rng.integers(0, 4)] for _ in range(length)]
        for (i, j) in stems:
            seq[j] = comp[seq[i]]
    # two point-mutated copies of the same long molecule
    seq_a = list(seq)
    seq_b = list(seq)
    for _ in range(60):
        seq_b[int(rng.integers(0, length))] = bases[rng.integers(0, 4)]
    recs = []
    for name, s in (("long_a", seq_a), ("long_b", seq_b)):
        rows = []
        partners = {}
        for (i, j) in stems:
            partners.setdefault(i, []).append(
                f"{round(float(rng.uniform(0.2, 0.95)), 3)}/{j + 1}")
            if rng.random() < 0.3:  # competing weak partner
                j2 = min(length - 1, j + int(rng.integers(1, 4)))
                partners[i].append(
                    f"{round(float(rng.uniform(0.05, 0.15)), 3)}/{j2 + 1}")
        for pos in range(length):
            cell = ",".join(partners.get(pos, [])) or "-"
            rows.append(f"{pos + 1} {s[pos]} {cell}")
        recs.append((name, rows))
    merged = ["## S1: long_a", "## S2: long_b"]
    for sid, (name, rows) in enumerate(recs, 1):
        merged.append(f"# S{sid} M{sid}")
        merged.extend(rows)
    _write("cfg4_long.ebpseq", "\n".join(merged) + "\n")


def make_goldens() -> None:
    sys.path.insert(0, os.path.join(HERE, "..", ".."))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from lara_tpu.app import run
    from lara_tpu.params import Parameters

    jobs = [
        ("cfg1_pair.dbn", "cfg1.lib", dict()),
        ("cfg2_bpp.ebpseq", "cfg2.lib", dict(num_iterations=100)),
        ("cfg3_family.sth", "cfg3.lib", dict(num_iterations=50)),
        ("cfg4_long.ebpseq", "cfg4.lib", dict(num_iterations=3)),
        ("cfg1_pair.dbn", "cfg5.pairs", dict(out_format="pairs")),
    ]
    for in_name, out_name, extra in jobs:
        params = Parameters(
            in_file=os.path.join(HERE, in_name),
            out_file=os.path.join(HERE, out_name),
            backend="reference",
            **extra,
        )
        run(params)
        print(f"golden {out_name} written")


if __name__ == "__main__":
    make_inputs()
    make_goldens()
