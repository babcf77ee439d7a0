// Native per-pair Lagrange bookkeeping for the hybrid solver.
//
// The hybrid backend splits each subgradient iteration the way the hardware
// wants: the O(L^2) batched alignment DP runs on the device (the CUDA
// wavefront kernel on a GPU), while the sparse per-pair bookkeeping -- priority-queue maxima,
// subgradient extraction, greedy matching, dual updates, PSSM maintenance --
// runs here in C++, touching only O(lines * partners) state per iteration
// exactly like the reference (updateScores, /root/reference/src/
// lagrange.hpp:312-323).  Dense [B, D] device formulations of this
// bookkeeping cost ~10ms per gather/scatter at D ~ 64k; this code does the
// same work in microseconds.
//
// Semantics are a line-for-line port of the *tested* Python mirror
// (lara_tpu/solver/reference_driver.py) of lagrange.hpp / matching.hpp /
// subgradient_solver.hpp: int32 fixed-point profits, float32 step sizes with
// trunc-toward-zero dual writeback, queue tie-breaking by smallest partner
// id, and the greedy lookahead matching with the exact solveConflicts
// recursion.
//
// C ABI for ctypes; no Python.h.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <set>
#include <unordered_map>
#include <vector>

typedef int32_t i32;
typedef int64_t i64;
using std::vector;

namespace {

constexpr i64 INFTY = ((i64)INT32_MAX) / 3 * 2;  // data_types.hpp:77
constexpr i32 PSSM_INIT_SENTINEL = (i32)(-((i64)INT32_MAX) / 3 * 2);  // score.hpp:92

struct Solver {
    int la = 0, lb = 0, ne = 0;
    int n_dual = 0;
    vector<i32> seq_score;  // [ne]
    vector<uint8_t> active; // [ne]
    vector<i32> dual_l, dual_m, sscore, rev;  // [D]
    vector<i32> dual;           // [D]
    vector<i32> dual_at_queue;  // [D] snapshot the PSSM reflects
    // CSR: partner dual indices grouped by dual_l
    vector<i32> csr_off;  // [ne+1]
    vector<i32> csr_idx;  // [D]

    // config
    int num_iterations = 500, max_nondecr = 50, lookahead = 5;
    float step_factor = 1.0f;

    // loop state
    int remaining = 0, nondecreasing = 0, iterations = 0;
    i64 best_upper = INFTY, best_lower = -INFTY;
    i64 best_score = -INFTY;
    vector<i32> best_lines;               // edge ids
    std::unordered_map<i32, i32> best_contacts;
    bool done = false;

    // PSSM output buffer (caller-owned, row stride in elements)
    i32* pssm = nullptr;
    int pssm_stride = 0;

    i64 profit(int didx) const { return (i64)sscore[didx] + (i64)dual[didx]; }

    // first element of priorityQ[edge]: (max profit incl. self entry at 0,
    // tie -> smallest partner id)  [reference_driver._top_entry]
    void top_entry(int edge, i64* out_profit, i32* out_partner) const {
        i64 best_p = 0;
        i32 best_m = edge;
        for (int k = csr_off[edge]; k < csr_off[edge + 1]; ++k) {
            int didx = csr_idx[k];
            i64 p = profit(didx);
            i32 m = dual_m[didx];
            if (p > best_p || (p == best_p && m < best_m)) {
                best_p = p;
                best_m = m;
            }
        }
        *out_profit = best_p;
        *out_partner = best_m;
    }

    void write_pssm_edge(int edge) {
        i64 best_p = -INFTY;
        for (int k = csr_off[edge]; k < csr_off[edge + 1]; ++k) {
            i64 p = profit(csr_idx[k]);
            if (p > best_p) best_p = p;
        }
        i64 bonus = best_p > 0 ? best_p : 0;
        int a = edge / lb, b = edge % lb;
        pssm[a * pssm_stride + b] = (i32)((i64)seq_score[edge] + bonus);
    }

    void build_full_pssm() {
        for (int a = 0; a < la; ++a)
            for (int b = 0; b < lb; ++b) {
                int edge = a * lb + b;
                if (active[edge])
                    write_pssm_edge(edge);
                else
                    pssm[a * pssm_stride + b] = PSSM_INIT_SENTINEL;
            }
    }
};

// ---------------------------------------------------------------- matching

typedef std::array<i64, 3> Interaction;  // (-2*score, lineL, lineR)

}  // namespace

// provided by blossom.cpp (linked into this shared object): exact
// maximum-weight matching, the -m 0 LEMON equivalent (matching.hpp:201-238)
extern "C" long long lara_max_weight_matching(
    int n, int m, const int* us, const int* vs, const long long* ws,
    int* mate_out);

namespace {

// exact matching (-m 0), mirroring matching_ref.exact_matching: edges are
// (line, partner, 2*score) with non-positive weights dropped; every line
// starts as its own contact (the matching.hpp:210 quirk)
static i64 exact_matching(
    const vector<vector<std::pair<i64, i32>>>& possible,
    const vector<i32>& lines,
    std::unordered_map<i32, i32>* contacts) {
    contacts->clear();
    for (i32 line : lines) (*contacts)[line] = line;
    // collect positive-weight edges and compact vertex ids
    vector<i32> us, vs;
    vector<long long> ws;  // blossom's ABI type (i64 is long on LP64)
    std::map<i32, int> compact;  // ordered: deterministic ids
    vector<i32> vertex_ids;
    for (size_t idx = 0; idx < lines.size(); ++idx) {
        for (const auto& sp : possible[idx]) {
            i64 w = 2 * sp.first;
            i32 u = lines[idx], v = sp.second;
            if (w <= 0 || u == v) continue;
            us.push_back(u);
            vs.push_back(v);
            ws.push_back(w);
            compact.emplace(u, 0);
            compact.emplace(v, 0);
        }
    }
    if (ws.empty()) return 0;
    int n = 0;
    for (auto& kv : compact) {
        vertex_ids.push_back(kv.first);
        kv.second = n++;
    }
    vector<int> cu(us.size()), cv(vs.size());
    for (size_t k = 0; k < us.size(); ++k) {
        cu[k] = compact[us[k]];
        cv[k] = compact[vs[k]];
    }
    vector<int> mate(n);
    long long total = lara_max_weight_matching(
        n, (int)ws.size(), cu.data(), cv.data(), ws.data(), mate.data());
    for (int v = 0; v < n; ++v) {
        if (mate[v] > v) {
            i32 a = vertex_ids[v], b = vertex_ids[mate[v]];
            (*contacts)[a] = b;
            (*contacts)[b] = a;
        }
    }
    return (i64)total;
}

static bool has_conflict(const Interaction& a, const Interaction& b) {
    return a[1] == b[1] || a[1] == b[2] || a[2] == b[1] || a[2] == b[2];
}

// exact port of solveConflicts (matching.hpp:99-141 via matching_ref.py)
static void solve_conflicts(
    const vector<std::pair<Interaction, Interaction>>& conflicts,
    std::set<Interaction>* eliminate, i64* weight) {
    eliminate->clear();
    *weight = 0;
    if (conflicts.empty()) return;
    const Interaction& fa = conflicts[0].first;
    const Interaction& fb = conflicts[0].second;
    Interaction edge_s = std::max(fa, fb);  // tuple-greater = lighter
    Interaction edge_l = std::min(fa, fb);
    i64 weight_s = -edge_s[0];
    i64 weight_l = -edge_l[0];

    if (conflicts.size() == 1) {
        eliminate->insert(edge_s);
        *weight = weight_s;
        return;
    }
    vector<std::pair<Interaction, Interaction>> remaining_s;
    for (const auto& c : conflicts)
        if (edge_s != c.first && edge_s != c.second) remaining_s.push_back(c);
    std::set<Interaction> elim_s;
    i64 sub_s;
    solve_conflicts(remaining_s, &elim_s, &sub_s);
    weight_s += sub_s;

    if (weight_s > weight_l) {
        vector<std::pair<Interaction, Interaction>> remaining_l;
        for (const auto& c : conflicts)
            if (edge_l != c.first && edge_l != c.second) remaining_l.push_back(c);
        if (remaining_s != remaining_l) {
            std::set<Interaction> elim_l;
            i64 sub_l;
            solve_conflicts(remaining_l, &elim_l, &sub_l);
            i64 total_l = weight_l + sub_l;
            if (weight_s > total_l) {
                elim_l.insert(edge_l);
                *eliminate = std::move(elim_l);
                *weight = total_l;
                return;
            }
        }
    }
    elim_s.insert(edge_s);
    *eliminate = std::move(elim_s);
    *weight = weight_s;
}

// greedy lookahead matching (computeGreedyMatching, matching.hpp:143-192)
static i64 greedy_matching(
    const vector<vector<std::pair<i64, i32>>>& possible,  // per line: (score, partner)
    const vector<i32>& lines, int lookahead,
    std::unordered_map<i32, i32>* contacts) {
    std::set<Interaction> queue;
    for (size_t idx = 0; idx < lines.size(); ++idx)
        for (const auto& sp : possible[idx])
            queue.insert({-2 * sp.first, (i64)lines[idx], (i64)sp.second});

    size_t lh = (size_t)lookahead;
    if (lh > queue.size())
        lh = queue.size();
    else if (lh == 0)
        lh = 5;

    contacts->clear();
    i64 total = 0;
    auto it = queue.begin();
    while (it != queue.end()) {
        vector<Interaction> selection;
        while (selection.size() < lh && it != queue.end()) {
            const Interaction& entry = *it;
            ++it;
            if (!contacts->count((i32)entry[1]) && !contacts->count((i32)entry[2]))
                selection.push_back(entry);
        }
        vector<std::pair<Interaction, Interaction>> conflicts;
        for (size_t i = 0; i < selection.size(); ++i)
            for (size_t j = i + 1; j < selection.size(); ++j)
                if (has_conflict(selection[i], selection[j]))
                    conflicts.emplace_back(selection[i], selection[j]);
        std::set<Interaction> eliminate;
        i64 w;
        solve_conflicts(conflicts, &eliminate, &w);
        for (const auto& entry : selection) {
            if (!eliminate.count(entry)) {
                (*contacts)[(i32)entry[1]] = (i32)entry[2];
                (*contacts)[(i32)entry[2]] = (i32)entry[1];
                total += -entry[0];
            }
        }
    }
    return total;
}

}  // namespace

extern "C" {

void* lara_lagrange_create(
    int la, int lb, const i32* seq_score, const uint8_t* active,
    int n_dual, const i32* dual_l, const i32* dual_m, const i32* sscore,
    const i32* rev,
    int num_iterations, int max_nondecr, float step_factor, int lookahead,
    i32* pssm_out, int pssm_stride) {
    Solver* s = new Solver();
    s->la = la;
    s->lb = lb;
    s->ne = la * lb;
    s->n_dual = n_dual;
    s->seq_score.assign(seq_score, seq_score + s->ne);
    s->active.assign(active, active + s->ne);
    s->dual_l.assign(dual_l, dual_l + n_dual);
    s->dual_m.assign(dual_m, dual_m + n_dual);
    s->sscore.assign(sscore, sscore + n_dual);
    s->rev.assign(rev, rev + n_dual);
    s->dual.assign(n_dual, 0);
    s->dual_at_queue.assign(n_dual, 0);
    s->num_iterations = num_iterations;
    s->max_nondecr = max_nondecr;
    s->step_factor = step_factor;
    s->lookahead = lookahead;
    s->remaining = num_iterations;
    s->pssm = pssm_out;
    s->pssm_stride = pssm_stride;

    // CSR by dual_l (counting sort, stable)
    s->csr_off.assign(s->ne + 1, 0);
    for (int d = 0; d < n_dual; ++d) s->csr_off[dual_l[d] + 1]++;
    for (int e = 0; e < s->ne; ++e) s->csr_off[e + 1] += s->csr_off[e];
    s->csr_idx.resize(n_dual);
    vector<i32> cursor(s->csr_off.begin(), s->csr_off.end() - 1);
    for (int d = 0; d < n_dual; ++d) s->csr_idx[cursor[dual_l[d]]++] = d;

    s->build_full_pssm();
    return s;
}

// One subgradient iteration given the device alignment result.
// lines_ab: [n_lines * 2] (a, b) pairs ascending; gap_score: affine gap score
// of the alignment; upper: the DP optimum (dual bound).
// upd_idx/upd_val (capacity upd_cap) receive the PSSM entries changed by
// this step (flat edge ids + new values) so the driver can ship a sparse
// device update; *n_upd = -1 signals capacity overflow (full re-upload).
// Returns 1 when converged/exhausted, 0 to continue, -1 on invariant failure.
int lara_lagrange_step_sparse(void* handle, const i32* lines_ab, int n_lines,
                              i32 gap_score, i32 upper,
                              i32* upd_idx, i32* upd_val, int upd_cap,
                              int* n_upd);

int lara_lagrange_step(void* handle, const i32* lines_ab, int n_lines,
                       i32 gap_score, i32 upper) {
    int n_upd = 0;
    return lara_lagrange_step_sparse(handle, lines_ab, n_lines, gap_score,
                                     upper, nullptr, nullptr, 0, &n_upd);
}

int lara_lagrange_step_sparse(void* handle, const i32* lines_ab, int n_lines,
                              i32 gap_score, i32 upper,
                              i32* upd_idx, i32* upd_val, int upd_cap,
                              int* n_upd) {
    Solver* s = (Solver*)handle;
    if (s->done) return 1;
    // snapshot the duals the current PSSM reflects (reference skips
    // updateScores on the terminating iteration)
    s->dual_at_queue = s->dual;

    vector<i32> line_edges(n_lines);
    std::set<i32> in_solution;
    for (int i = 0; i < n_lines; ++i) {
        i32 edge = lines_ab[2 * i] * s->lb + lines_ab[2 * i + 1];
        if (!s->active[edge]) return -1;  // lagrange.hpp:338 assert
        line_edges[i] = edge;
        in_solution.insert(edge);
    }

    // ---- subgradients (lagrange.hpp:343-374) ----
    std::unordered_map<i32, float> sg_sign;
    vector<i32> sg_order;  // insertion order incl. duplicates (step denominator)
    for (i32 edge : line_edges) {
        i64 top_p;
        i32 top_m;
        s->top_entry(edge, &top_p, &top_m);
        // tied partners ascending by partner id
        std::map<i32, i32> tied;  // partner -> didx
        for (int k = s->csr_off[edge]; k < s->csr_off[edge + 1]; ++k) {
            int didx = s->csr_idx[k];
            if (s->profit(didx) == top_p) tied[s->dual_m[didx]] = didx;
        }
        for (const auto& pm : tied) {
            i32 partner = pm.first;
            int didx = pm.second;
            bool found_cycle = false;
            if (in_solution.count(partner)) {
                i64 p_top;
                i32 p_m;
                s->top_entry(partner, &p_top, &p_m);
                int rev_didx = s->rev[didx];
                if (s->profit(rev_didx) == p_top) found_cycle = true;
            }
            if (!found_cycle) {
                int rev_didx = s->rev[didx];
                sg_sign[didx] = 1.0f;
                sg_order.push_back(didx);
                sg_sign[rev_didx] = -1.0f;
                sg_order.push_back(rev_didx);
            }
        }
    }

    // ---- lower bound ----
    i64 lower = 0;
    for (int i = 0; i < n_lines; ++i)
        lower += (i64)s->seq_score[line_edges[i]];

    std::unordered_map<i32, i32> contacts;
    if (!sg_order.empty()) {
        // matching branch (lagrange.hpp:380-395)
        vector<vector<std::pair<i64, i32>>> possible(line_edges.size());
        for (size_t idx = 0; idx < line_edges.size(); ++idx) {
            i32 edge = line_edges[idx];
            vector<std::array<i64, 3>> plist;  // (-profit, partner, sscore)
            for (int k = s->csr_off[edge]; k < s->csr_off[edge + 1]; ++k) {
                int didx = s->csr_idx[k];
                i32 partner = s->dual_m[didx];
                if (in_solution.count(partner) && edge < partner)
                    plist.push_back({-s->profit(didx), (i64)partner,
                                     (i64)s->sscore[didx]});
            }
            std::sort(plist.begin(), plist.end());
            for (const auto& t : plist)
                possible[idx].emplace_back(t[2], (i32)t[1]);
        }
        if (s->lookahead == 0)  // -m 0: exact MWM (matching.hpp:201-238)
            lower += exact_matching(possible, line_edges, &contacts);
        else
            lower += greedy_matching(possible, line_edges, s->lookahead,
                                     &contacts);
    } else {
        // consistent branch (lagrange.hpp:397-409)
        for (i32 edge : line_edges) {
            i64 top_p;
            i32 partner;
            s->top_entry(edge, &top_p, &partner);
            if (partner != edge) {
                for (int k = s->csr_off[edge]; k < s->csr_off[edge + 1]; ++k) {
                    int didx = s->csr_idx[k];
                    if (s->dual_m[didx] == partner) {
                        lower += (i64)s->sscore[didx];
                        break;
                    }
                }
                contacts[edge] = partner;
                contacts[partner] = edge;
            }
        }
    }

    i64 primal = lower + (i64)gap_score;
    if (primal > s->best_score) {
        s->best_score = primal;
        s->best_lines.assign(line_edges.begin(), line_edges.end());
        s->best_contacts = contacts;
    }

    // ---- bound bookkeeping (subgradient_solver.hpp:247-263) ----
    if ((i64)upper < s->best_upper) {
        s->best_upper = upper;
        s->nondecreasing = 0;
    }
    if (primal > s->best_lower) {
        s->best_lower = primal;
        s->nondecreasing = 0;
    }
    if (s->nondecreasing >= s->max_nondecr) {
        s->step_factor = s->step_factor / 2.0f;
        s->nondecreasing = 0;
    } else {
        s->nondecreasing += 1;
    }

    // ---- dual update (subgradient_solver.hpp:265-271) ----
    *n_upd = 0;
    if (!sg_order.empty()) {
        float step_size = s->step_factor *
                          (float)(s->best_upper - s->best_lower) /
                          (float)sg_order.size();
        std::set<i32> touched_edges;
        for (const auto& kv : sg_sign) {
            int didx = kv.first;
            float nv = std::trunc((float)s->dual[didx] - step_size * kv.second);
            s->dual[didx] = (i32)(i64)nv;
            touched_edges.insert(s->dual_l[didx]);
        }
        // refresh only the touched PSSM entries (updateScores semantics)
        for (i32 edge : touched_edges) {
            // indices are emitted in the caller's (strided) plane layout
            i32 plane_idx = (edge / s->lb) * s->pssm_stride + edge % s->lb;
            i32 before = s->pssm[plane_idx];
            s->write_pssm_edge(edge);
            i32 after = s->pssm[plane_idx];
            if (after == before || upd_cap == 0) continue;
            if (*n_upd >= 0 && *n_upd < upd_cap) {
                upd_idx[*n_upd] = plane_idx;
                upd_val[*n_upd] = after;
                (*n_upd)++;
            } else {
                *n_upd = -1;  // overflow: caller re-uploads the full PSSM
            }
        }
    }

    s->remaining -= 1;
    s->iterations += 1;
    // NOTE: the reference's bound asserts here are debug-only
    // (subgradient_solver.hpp:274-283); release tolerates tie-induced bound
    // crossing and continues with a negative step size.  Mirror that.
    if (s->best_upper == s->best_lower || s->remaining == 0) {
        s->done = true;
        return 1;
    }
    return 0;
}

// Result extraction: getStructureLines (lagrange.hpp:437-487).
// cols_out: [3 * capacity] (a, b, weight) triplets; returns n_cols or -1.
int lara_lagrange_result(void* handle, int lib_linear, i32 lib_min, i32 lib_max,
                         i32* cols_out, int capacity, i64* meta_out) {
    Solver* s = (Solver*)handle;
    // evaluate top entries at the last queue-visible duals
    std::swap(s->dual, s->dual_at_queue);
    int n = (int)s->best_lines.size();
    if (n > capacity) {
        std::swap(s->dual, s->dual_at_queue);
        return -1;
    }
    if (lib_linear) {
        i64 min_score = INT64_MAX, max_score = INT64_MIN;
        for (int e = 0; e < s->ne; ++e) {
            if (!s->active[e]) continue;
            i64 top_p;
            i32 m;
            s->top_entry(e, &top_p, &m);
            i64 val = (i64)s->seq_score[e] + (top_p > 0 ? top_p : 0);
            min_score = std::min(min_score, val);
            max_score = std::max(max_score, val);
        }
        float div = 0.0f;
        if (max_score > min_score)
            div = 1.0f * (float)(lib_max - lib_min) / (float)(max_score - min_score);
        for (int i = 0; i < n; ++i) {
            i32 edge = s->best_lines[i];
            i64 top_p;
            i32 m;
            s->top_entry(edge, &top_p, &m);
            i64 top_val = (i64)s->seq_score[edge] + (top_p > 0 ? top_p : 0);
            int matched = s->best_contacts.count(edge) ? 1 : 0;
            i32 val = (i32)(i64)std::trunc((float)(matched * (top_val - min_score)) * div);
            cols_out[3 * i] = edge / s->lb;
            cols_out[3 * i + 1] = edge % s->lb;
            cols_out[3 * i + 2] = lib_min + val;
        }
    } else {
        for (int i = 0; i < n; ++i) {
            i32 edge = s->best_lines[i];
            int matched = s->best_contacts.count(edge) ? 1 : 0;
            cols_out[3 * i] = edge / s->lb;
            cols_out[3 * i + 1] = edge % s->lb;
            cols_out[3 * i + 2] = matched * 500 + 500;
        }
    }
    std::swap(s->dual, s->dual_at_queue);
    meta_out[0] = n;
    meta_out[1] = s->best_lower;
    meta_out[2] = s->best_upper;
    meta_out[3] = s->iterations;
    return n;
}

void lara_lagrange_destroy(void* handle) { delete (Solver*)handle; }
}
