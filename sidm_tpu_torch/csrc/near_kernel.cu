// Leaf-segment pair forces for every target group: the port of
// sidm_tpu/ops/pallas_near.py:_near_kernel (driven by near_items, :76; see
// sidm_tpu_torch/ops/near_kernel.py for the contract).
//
// What bounds it on the H100: the pair math. The lists of the flagship's
// main path hold ~1.2e9 (target, particle) pairs per evaluation, and one
// group covers up to ~2e5 particles while the mean is ~1e3, so the design
// is about spending few instructions per pair and about spreading heavy
// groups over the card:
//   * cover_count (work_items.cuh) sums each group's covered particles
//     (key & 31 over the live prefix); items_plan (work_items.cuh) cuts
//     the groups into work items of about equal covered-particle count;
//     near_mark finds each item's first and last key with a block-wide
//     scan of the group's counts. An item never splits a key.
//   * near_level_kernel runs one 256-thread block per item (a grid of
//     icap blocks; those past the last item return at once, and the block
//     scheduler balances the rest). A block decodes 256 keys at a time
//     with a block-wide scan and stages exactly the covered particles into
//     SoA shared memory, tiles of up to 512 slots, with cp.async double
//     buffering: the next tile's loads are in flight while the current
//     tile computes.
//   * 64 targets x 4 source slices per block: thread (slice, t) takes every
//     fourth staged particle against target t; the four partial sums are
//     added in shared memory in a fixed order. Four slices, not two
//     targets per thread: at ~40 registers a thread, 256-thread blocks
//     with 30 KB of shared memory run 6 to an SM (48 warps, bound by
//     registers), and a shared-memory broadcast per pair is far below the
//     SM's load rate.
//   * Pair math without a division: (2.8 eps)^2 and 1/(2.8 eps) once per
//     target and per staged particle; the Newtonian test is
//     r^2 < max(h_t^2, h_j^2) (two instructions), 1/r comes from
//     rsqrt.approx and the rest is FMA (this source is built with FMA).
//     The softened branch (few of the flagship's near pairs, profile_step
//     prints the share) runs only where r < h, with
//     h_inv = min(h_inv_t, h_inv_j), which equals 1/(2.8 max(eps))
//     exactly (rounding is monotone), as an FMA polynomial (softening.cuh
//     spline_soft). Testing r^2 h_inv^2 < 1 instead costs two more
//     instructions a pair; deferring the softened pairs of 32-pair batches
//     to a second loop saves the branch but spends as much on the
//     bookkeeping.
//   * items_fold (items::ItemsSum) adds each group's item slots in item
//     order: no float atomics, the same result from run to run, every
//     group written.
//
// Periodic mode (PBC, the TreePM split's short range; port of
// sidm_tpu/ops/fused_force.py:_near_tile's pbc branch :350-420, which
// JAX's periodic walk runs in XLA): the pair vector is the minimum image,
// d - box rint(d / box) (half to even, as torch.round); a pair beyond
// rcut adds nothing; the force factor is pm.short_range_fac: inside the
// softening softened_inv_r3(r, h) - g(r) with g = a^3 (erf(x) -
// (2/sqrt(pi)) x e^-x^2) / x^3 (x = a r) and its series below x = 0.2,
// beyond it S(r) / r^3 (S = erfc(x) + (2/sqrt(pi)) x e^-x^2: the
// difference form cancels near rcut); the potential pm.short_range_pot,
// softened_potential(r, h) + erf(x) / r and its series below x = 0.1
// inside, -erfc(x) / r beyond; IEEE division and sqrt (softening.cuh's
// softened_inv_r3 / softened_potential): most near pairs of a clustered
// box lie inside the softening, where both the spline and the screen act.
// The staged slots keep h = 2.8 eps instead of its reciprocal.
//
// Free-space mode (the same mode with box = 0: PMVacuum's short range in an
// isolated run, _near_tile with pbc = (0, alpha, rcut)): the plain pair
// vector, no minimum image; the rest as above.
//
// Ewald mode (EWALD, PMGrid -1: the per-pair Ewald walk, port of the
// segment pairs of sidm_tpu/ops/treeforce.py:eval_flat :391-430): the
// minimum-image pair vector, the softened pair force and potential
// (softening.cuh's softened_inv_r3 / softened_potential, IEEE division) and
// m times the Ewald correction of d (ewald.cuh); no cut. The self pair
// adds -2.8 m / h and psi(0) m to the potential (the caller removes the
// first, the spline self term, and keeps the lattice self energy).
#include <cuda_runtime.h>
#include <stdint.h>

#include "ewald.cuh"
#include "softening.cuh"
#include "work_items.cuh"

namespace {

constexpr int kG = 64;               // targets per group
constexpr int kThreads = 256;
constexpr int kSlices = kThreads / kG;
constexpr int kKW = kThreads;        // keys decoded per window
constexpr int kTP = 512;             // staged particle slots per tile
constexpr int kPMin = 512;           // least covered particles per item

struct NearSmem {
    float4 pm[2][kTP];               // x y z m
    float hi[2][kTP];                // eps, then 1/(2.8 eps)
    float h2[2][kTP];                // (2.8 eps)^2
    int wstart[kKW];                 // window keys' first particle
    int woff[kKW + 1];               // exclusive scan of their counts
    int wsum[kThreads / 32];
    float red[kSlices - 1][kG][4];
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// First key (k0) and end key (k1) of every item: one block per group. Key
// k belongs to item min(e_k / unit, items - 1), e_k the exclusive scan of
// the counts; an item starts where that index steps up.
__global__ void __launch_bounds__(kThreads)
near_mark(const int* __restrict__ keys, const int* __restrict__ n_seg,
          int K, const int* __restrict__ unit, const int* __restrict__ off,
          int* __restrict__ k0, int* __restrict__ k1) {
    __shared__ int sh[kThreads / 32];
    const int g = blockIdx.x, tid = threadIdx.x;
    const int base = off[g], n_it = off[g + 1] - base;
    if (n_it == 0) return;
    const int P = unit[g];
    const int nseg = min(max(n_seg[g], 0), K);
    const int* kg = keys + (int64_t)g * K;
    if (tid == 0) {
        k0[base] = 0;
        k1[base + n_it - 1] = nseg;
    }
    int carry = 0;
    for (int c0 = 0; c0 < nseg; c0 += kThreads) {
        const int k = c0 + tid;
        int cnt = 0;
        if (k < nseg) {
            const int key = kg[k];
            cnt = (key != SIDM_IMAX) ? (key & 31) : 0;
        }
        int total;
        const int ex = carry + items::block_exclusive_scan<kThreads>(
                                   cnt, sh, &total);
        if (k + 1 < nseg) {
            const int a = min(ex / P, n_it - 1);
            const int b = min((ex + cnt) / P, n_it - 1);
            if (b != a) {            // key k + 1 starts item b
                k0[base + b] = k + 1;
                k1[base + b - 1] = k + 1;
            }
        }
        carry += total;
    }
}

// Decode keys [w0, w1) of one group into the window (all threads).
__device__ __forceinline__ void decode_window(const int* kg, int w0, int w1,
                                              NearSmem& sm) {
    const int tid = threadIdx.x;
    const int k = w0 + tid;
    int start = 0, cnt = 0;
    if (k < w1) {
        const int key = kg[k];
        if (key != SIDM_IMAX) {
            start = key >> 5;
            cnt = key & 31;
        }
    }
    int total;
    const int ex = items::block_exclusive_scan<kThreads>(cnt, sm.wsum, &total);
    sm.wstart[tid] = start;
    sm.woff[tid + 1] = ex + cnt;
    if (tid == 0) sm.woff[0] = 0;
    __syncthreads();
}

// Largest b in (a, nk] with woff[b] - woff[a] <= kTP (a key covers <= 31).
__device__ __forceinline__ int tile_end(const NearSmem& sm, int a, int nk) {
    int lo = a + 1, hi = nk;
    const int lim = sm.woff[a] + kTP;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (sm.woff[mid] <= lim) lo = mid; else hi = mid - 1;
    }
    return lo;
}

// Start the cp.async copies of the particles of window keys [a, b) into
// buffer buf.
__device__ __forceinline__ void stage_tile(NearSmem& sm, int buf, int a,
                                           int b, const float* pos_s,
                                           const float* mass_s,
                                           const float* eps_s, int n) {
    const int base = sm.woff[a];
    const int C = sm.woff[b] - base;
    for (int s = threadIdx.x; s < C; s += kThreads) {
        const int sa = base + s;
        int lo = a, hi = b - 1;      // the last key with woff <= sa
        while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (sm.woff[mid] <= sa) lo = mid; else hi = mid - 1;
        }
        const int p = min(sm.wstart[lo] + sa - sm.woff[lo], n - 1);
        float* dst = reinterpret_cast<float*>(&sm.pm[buf][s]);
        cp_async4(dst + 0, pos_s + (int64_t)p * 3 + 0);
        cp_async4(dst + 1, pos_s + (int64_t)p * 3 + 1);
        cp_async4(dst + 2, pos_s + (int64_t)p * 3 + 2);
        cp_async4(dst + 3, mass_s + p);
        cp_async4(&sm.hi[buf][s], eps_s + p);
    }
}

// The pass's modes: the plain softened pairs, the screened ones (TreePM:
// periodic with box > 0, free-space with box = 0), the Ewald ones.
enum { kOpen = 0, kScreened = 1, kEwald = 2 };

struct Pbc {
    float box, alpha, rcut;
    EwaldTab ew;                     // kEwald: the table (box = ew.box)
};

// d - box rint(d / box) (half to even, as torch.round); d itself with no
// box (the free-space mode).
__device__ __forceinline__ float min_image(float d, float box) {
    return box > 0.0f ? d - box * rintf(d / box) : d;
}

// One periodic pair (see the note at the top): the source q (xyz, m)
// with h = 2.8 max(eps_t, eps_j) against the target x.
template <bool POT>
__device__ __forceinline__ void pbc_pair(const float4& q, float h, float x0,
                                         float x1, float x2, const Pbc& pb,
                                         float* ax, float* ay, float* az,
                                         float* pot) {
    constexpr float kTwoOverSqrtPi = 1.1283791670955126f;
    const float d0 = min_image(q.x - x0, pb.box);
    const float d1 = min_image(q.y - x1, pb.box);
    const float d2 = min_image(q.z - x2, pb.box);
    const float r = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
    if (!(r <= pb.rcut)) return;
    const float x = pb.alpha * r;
    const float xx = x * x;
    float fac, ph;
    if (r >= h) {
        // S(r) / r^3 and -erfc(a r) / r (no cancellation near rcut)
        const float ec = erfcf(x);
        const float ir = 1.0f / fmaxf(r, 1e-30f);
        fac = (ec + kTwoOverSqrtPi * x * expf(-xx)) * (ir * ir * ir);
        ph = -ec * ir;
    } else {
        const float xs = fmaxf(x, 1e-12f);
        float g;
        if (x < 0.2f)
            g = (4.0f / (3.0f * 1.7724538509055159f))
                * (1.0f - 0.6f * xx + (3.0f / 14.0f) * xx * xx);
        else
            g = (erff(xs) - kTwoOverSqrtPi * xs * expf(-xx))
                / (xs * xs * xs);
        fac = softened_inv_r3(r, h) - pb.alpha * pb.alpha * pb.alpha * g;
        ph = 0.0f;
        if (POT)
            ph = softened_potential(r, h)
                 + (x < 0.1f ? pb.alpha * kTwoOverSqrtPi * (1.0f - xx / 3.0f)
                             : erff(xs) / fmaxf(r, 1e-30f));
    }
    fac *= q.w;
    *ax = fmaf(fac, d0, *ax);
    *ay = fmaf(fac, d1, *ay);
    *az = fmaf(fac, d2, *az);
    if (POT) *pot = fmaf(q.w, ph, *pot);
}

// One Ewald-mode pair (see the note at the top): the source q (xyz, m)
// with h = 2.8 max(eps_t, eps_j) against the target x.
template <bool POT>
__device__ __forceinline__ void ewald_pair(const float4& q, float h,
                                           float x0, float x1, float x2,
                                           const EwaldTab& ew, float* ax,
                                           float* ay, float* az,
                                           float* pot) {
    const float d0 = min_image(q.x - x0, ew.box);
    const float d1 = min_image(q.y - x1, ew.box);
    const float d2 = min_image(q.z - x2, ew.box);
    const float r = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
    float c[4];
    ewald_corr<POT>(d0, d1, d2, ew, c);
    const float fac = softened_inv_r3(r, h);
    *ax = fmaf(q.w, fmaf(fac, d0, c[0]), *ax);
    *ay = fmaf(q.w, fmaf(fac, d1, c[1]), *ay);
    *az = fmaf(q.w, fmaf(fac, d2, c[2]), *az);
    if (POT) *pot = fmaf(q.w, softened_potential(r, h) + c[3], *pot);
}

template <bool POT, int MODE>
__global__ void __launch_bounds__(kThreads)
near_level_kernel(const int* __restrict__ keys, int K,
                  const int* __restrict__ item_g,
                  const int* __restrict__ item_k0,
                  const int* __restrict__ item_k1,
                  const int* __restrict__ n_items,
                  const float* __restrict__ pos_s,
                  const float* __restrict__ mass_s,
                  const float* __restrict__ eps_s, int n,
                  const float* __restrict__ xr, const float* __restrict__ te,
                  float* __restrict__ part, const Pbc pb) {
    __shared__ NearSmem sm;
    const int tid = threadIdx.x;
    const int t = tid & (kG - 1);
    const int slice = tid / kG;
    const int it = blockIdx.x;
    if (it >= *n_items) return;
    const int g = item_g[it];
    const int kb0 = item_k0[it], kb1 = item_k1[it];
    const int* kg = keys + (int64_t)g * K;
    const float x0 = xr[(g * kG + t) * 3 + 0];
    const float x1 = xr[(g * kG + t) * 3 + 1];
    const float x2 = xr[(g * kG + t) * 3 + 2];
    const float ht = 2.8f * te[g * kG + t];
    const float hit = 1.0f / ht, h2t = ht * ht;
    float ax = 0.0f, ay = 0.0f, az = 0.0f, pot = 0.0f;

    int w1 = min(kb0 + kKW, kb1);
    decode_window(kg, kb0, w1, sm);
    int nk = w1 - kb0;
    int a = 0, b = tile_end(sm, 0, nk);
    stage_tile(sm, 0, a, b, pos_s, mass_s, eps_s, n);
    cp_async_commit();
    int buf = 0;
    for (;;) {
        const int C = sm.woff[b] - sm.woff[a];
        // the next tile: in this window, or the first of the next one
        bool next = true;
        if (b < nk) {
            a = b;
        } else if (w1 < kb1) {
            __syncthreads();     // everyone is done with this window
            const int w0 = w1;
            w1 = min(w0 + kKW, kb1);
            decode_window(kg, w0, w1, sm);
            nk = w1 - w0;
            a = 0;
        } else {
            next = false;
        }
        if (next) {
            b = tile_end(sm, a, nk);
            stage_tile(sm, buf ^ 1, a, b, pos_s, mass_s, eps_s, n);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        for (int s = tid; s < C; s += kThreads) {
            const float h = 2.8f * sm.hi[buf][s];
            sm.h2[buf][s] = h * h;
            sm.hi[buf][s] = MODE != kOpen ? h : 1.0f / h;
        }
        __syncthreads();
        const float4* pm = sm.pm[buf];
        const float* hs = sm.hi[buf];
        const float* h2s = sm.h2[buf];
        if (MODE != kOpen) {
            for (int j = slice; j < C; j += kSlices) {
                if (MODE == kScreened)
                    pbc_pair<POT>(pm[j], fmaxf(ht, hs[j]), x0, x1, x2, pb,
                                  &ax, &ay, &az, &pot);
                else
                    ewald_pair<POT>(pm[j], fmaxf(ht, hs[j]), x0, x1, x2,
                                    pb.ew, &ax, &ay, &az, &pot);
            }
            __syncthreads();     // buffer buf is refilled next
            if (!next) break;
            buf ^= 1;
            continue;
        }
#pragma unroll 4
        for (int j = slice; j < C; j += kSlices) {
            const float4 q = pm[j];
            const float d0 = q.x - x0, d1 = q.y - x1, d2 = q.z - x2;
            const float r2 = fmaf(d2, d2, fmaf(d1, d1, d0 * d0));
            float ir = rsqrt_fast(r2);
            float fac = ir * ir * ir, ph = -ir;
            if (r2 < fmaxf(h2t, h2s[j])) {
                const float hp = fminf(hit, hs[j]);
                ir = rsqrt_fast(fmaxf(r2, 1e-37f));
                spline_soft<POT>(r2 * ir * hp, hp, ir, ir * ir * ir, &fac,
                                 &ph);
            }
            fac *= q.w;
            ax = fmaf(fac, d0, ax);
            ay = fmaf(fac, d1, ay);
            az = fmaf(fac, d2, az);
            if (POT) pot = fmaf(q.w, ph, pot);
        }
        __syncthreads();         // buffer buf is refilled next
        if (!next) break;
        buf ^= 1;
    }

    items::store_item<kSlices, POT>(sm.red, part, it, ax, ay, az, pot);
}

int split(const int* keys, const int* n_seg, int ng, int K,
          const items::Ws& w, int icap, cudaStream_t st) {
    items::cover_count<<<(ng * 32 + 255) / 256, 256, 0, st>>>(
        keys, n_seg, ng, K, w.cov);
    int err = (int)cudaGetLastError();
    if (err) return err;
    items::items_plan<<<1, items::kPlanThreads, 0, st>>>(
        w.cov, SIDM_IMAX, ng, icap, kPMin, w.unit, w.off, w.item_g);
    if ((err = (int)cudaGetLastError())) return err;
    near_mark<<<ng, kThreads, 0, st>>>(keys, n_seg, K, w.unit, w.off, w.k0,
                                       w.k1);
    return (int)cudaGetLastError();
}

}  // namespace

// Per group the particles its live segment keys cover (tot (ng,) int32):
// cover_count alone, for the emission's launch order (ops/fused_range.py
// segment_totals).
extern "C" int segment_totals_launch(const int* keys, const int* n_seg,
                                     int ng, int K, int* tot, void* stream) {
    if (ng <= 0) return 0;
    items::cover_count<<<(ng * 32 + 255) / 256, 256, 0,
                         (cudaStream_t)stream>>>(keys, n_seg, ng, K, tot);
    return (int)cudaGetLastError();
}

// The work items alone (for checks): fills the workspace.
extern "C" int near_split_launch(const int* keys, const int* n_seg, int ng,
                                 int K, int* ws, int icap, void* stream) {
    if (ng <= 0) return 0;
    return split(keys, n_seg, ng, K, items::ws_of(ws, ng, icap, true), icap,
                 (cudaStream_t)stream);
}

// mode 0: the plain softened pairs; 1: the screened mode (box (0: free
// space), alpha, rcut the TreePM split); 2: the Ewald mode (table4 the
// interleaved Ewald table of grid en for the box).
extern "C" int near_level_launch(const int* keys, const int* n_seg, int ng,
                                 int K, const float* pos_s,
                                 const float* mass_s, const float* eps_s,
                                 int n, const float* xr, const float* te,
                                 int need_pot, float* acc, int* ws, int icap,
                                 float* part, float box, float alpha,
                                 float rcut, const float* table4, int en,
                                 int mode, void* stream) {
    if (ng <= 0) return 0;
    if (mode == kEwald && (!table4 || en < 2 || !(box > 0.0f)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const items::Ws w = items::ws_of(ws, ng, icap, true);
    int err = split(keys, n_seg, ng, K, w, icap, st);
    if (err) return err;
    auto kern = mode == kEwald
        ? (need_pot ? near_level_kernel<true, kEwald>
                    : near_level_kernel<false, kEwald>)
        : mode == kScreened
        ? (need_pot ? near_level_kernel<true, kScreened>
                    : near_level_kernel<false, kScreened>)
        : (need_pot ? near_level_kernel<true, kOpen>
                    : near_level_kernel<false, kOpen>);
    const Pbc pb{box, alpha, rcut,
                 ewald_tab(table4, box, mode == kEwald ? en : 0)};
    kern<<<icap, kThreads, 0, st>>>(keys, K, w.item_g, w.k0, w.k1,
                                    w.off + ng, pos_s, mass_s, eps_s, n, xr,
                                    te, part, pb);
    if ((err = (int)cudaGetLastError())) return err;
    items::items_fold<<<ng, 256, 0, st>>>(w.off, items::ItemsSum{part, acc});
    return (int)cudaGetLastError();
}
