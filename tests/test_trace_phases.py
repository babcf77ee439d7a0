"""The trace reduction kept with the benchmark: HLO scope attribution."""

import jax
import jax.numpy as jnp

from benchmark.trace_phases import _kernel_name, scopes_from_hlo


def test_kernel_name_sanitizes_hlo_names():
    assert _kernel_name("loop_select_fusion.2") == "loop_select_fusion_2"
    assert _kernel_name("wrapped_reduce-window") == "wrapped_reduce_window"


def test_scopes_from_compiled_hlo():
    """Instructions under a named scope of a while body map to that scope;
    the rest are left out (they count as ``other``)."""

    @jax.jit
    def step(x):
        def body(c):
            i, y = c
            with jax.named_scope("greedy_matching"):
                y = jnp.cumsum(jnp.sin(y)) * 2
            with jax.named_scope("dp_traceback"):
                y = y + jnp.max(y)
            return i + 1, y
        return jax.lax.while_loop(lambda c: c[0] < 3, body, (0, x))[1]

    hlo = step.lower(jnp.ones(16)).compile().as_text()
    scopes = scopes_from_hlo(hlo)
    assert "greedy_matching" in scopes.values()
    assert "dp_traceback" in scopes.values()
    assert all(v in ("greedy_matching", "dp_traceback")
               for v in scopes.values())
    assert all("." not in k and "-" not in k for k in scopes)
