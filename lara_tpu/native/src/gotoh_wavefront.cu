// Batched Gotoh affine-gap DP + traceback over position-specific scores, as
// one CUDA kernel called through XLA's foreign function interface.
//
// Same semantics as lara_tpu.ops.gotoh.align_pssm_batch (the XLA reference):
// recurrences, border values and tie-breaking (M > H > V at matches,
// extend-first in gaps) are identical, and all arithmetic is int32 with
// two's-complement wraparound, so every output is bit-equal.
//
// One thread block per lane (pair).  The block sweeps the anti-diagonals of
// that lane's own la x lb matrix with the diagonal loop inside the kernel:
// threads cover the cells of one diagonal, the M/H/V values of the last
// three diagonals rotate through shared memory, and one barrier separates
// consecutive diagonals.  Packed direction bytes (2 bits per M/H/V source)
// stay in shared memory when the whole lane fits, and go to a device-memory
// scratch result otherwise.  Thread 0 then walks the traceback and emits
// the dense partner map, the line count, the affine gap score and the
// sequence-score sum over matched cells.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int32_t kNegInf = -1431655764;  // lara::infinity negated
constexpr int kMat = 0, kHor = 1, kVer = 2;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}

// scalars[b] = (upper, gap_score, n_lines, seq_part)
template <bool kSmemDirs>
__global__ void __launch_bounds__(kMaxThreads)
gotoh_wavefront_kernel(const int32_t* __restrict__ pssm,
                       const int32_t* __restrict__ seq,
                       const int32_t* __restrict__ la_arr,
                       const int32_t* __restrict__ lb_arr,
                       const int32_t* __restrict__ gaps, int LA, int LB,
                       bool has_seq, int32_t* __restrict__ partner,
                       int32_t* __restrict__ scalars,
                       uint8_t* __restrict__ dirs_gmem) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = LA + 1;
  const size_t lane = blockIdx.x;
  int32_t* wave = reinterpret_cast<int32_t*>(smem);  // [3 diag][M,H,V][W]
  uint8_t* dirs = kSmemDirs
                      ? smem + 9 * static_cast<size_t>(W) * sizeof(int32_t)
                      : dirs_gmem + lane * static_cast<size_t>(LA + LB + 1) * W;
  // lengths beyond the padded shape would index outside this lane's rows
  const int la = min(max(la_arr[lane], 0), LA);
  const int lb = min(max(lb_arr[lane], 0), LB);
  const int32_t go = gaps[0];
  const int32_t ge = gaps[1];
  const int32_t* cell = pssm + lane * static_cast<size_t>(LA) * LB;

  for (int d = 0; d <= la + lb; ++d) {
    int32_t* cur = wave + (d % 3) * 3 * W;
    const int32_t* p1 = wave + ((d + 2) % 3) * 3 * W;  // diagonal d-1
    const int32_t* p2 = wave + ((d + 1) % 3) * 3 * W;  // diagonal d-2
    const int ilo = max(0, d - lb);
    const int ihi = min(d, la);
    const int32_t bg = d == 0 ? 0 : wadd(go, wmul(ge, d - 1));
    for (int i = ilo + static_cast<int>(threadIdx.x); i <= ihi;
         i += blockDim.x) {
      const int j = d - i;
      int32_t m2 = kNegInf, h2 = kNegInf, v2 = kNegInf;  // (i-1, j-1)
      int32_t m1 = kNegInf, h1 = kNegInf, v1 = kNegInf;  // (i, j-1)
      int32_t m1s = kNegInf, h1s = kNegInf, v1s = kNegInf;  // (i-1, j)
      int32_t score = 0;
      if (i >= 1 && j >= 1) {
        m2 = p2[i - 1];
        h2 = p2[W + i - 1];
        v2 = p2[2 * W + i - 1];
        score = cell[static_cast<size_t>(i - 1) * LB + (j - 1)];
      }
      if (j >= 1) {
        m1 = p1[i];
        h1 = p1[W + i];
        v1 = p1[2 * W + i];
      }
      if (i >= 1) {
        m1s = p1[i - 1];
        h1s = p1[W + i - 1];
        v1s = p1[2 * W + i - 1];
      }
      const int32_t best = max(max(m2, h2), v2);
      int32_t m_new = wadd(best, score);
      const int mdir = m2 == best ? kMat : (h2 == best ? kHor : kVer);

      const int32_t hh = wadd(h1, ge), hm = wadd(m1, go), hv = wadd(v1, go);
      int32_t h_new = max(max(hh, hm), hv);
      const int hdir = hh == h_new ? kHor : (hm == h_new ? kMat : kVer);

      const int32_t vv = wadd(v1s, ge), vm = wadd(m1s, go),
                    vh = wadd(h1s, go);
      int32_t v_new = max(max(vv, vm), vh);
      const int vdir = vv == v_new ? kVer : (vm == v_new ? kMat : kHor);

      if (i == 0 || j == 0) {  // borders: cell (0, d) and cell (d, 0)
        m_new = bg;
        if (d == 0) {
          h_new = kNegInf;
          v_new = kNegInf;
        } else if (i == 0) {
          h_new = bg;
          v_new = kNegInf;
        } else {
          h_new = kNegInf;
          v_new = bg;
        }
      }
      cur[i] = m_new;
      cur[W + i] = h_new;
      cur[2 * W + i] = v_new;
      dirs[static_cast<size_t>(d) * W + i] =
          static_cast<uint8_t>(mdir | (hdir << 2) | (vdir << 4));
    }
    __syncthreads();
  }

  int32_t* prow = partner + lane * LA;
  for (int a = la + static_cast<int>(threadIdx.x); a < LA; a += blockDim.x) {
    prow[a] = -1;  // the walk below writes every row a < la exactly once
  }
  if (threadIdx.x != 0) return;

  const int32_t* fin = wave + ((la + lb) % 3) * 3 * W;
  const int32_t fm = fin[la], fh = fin[W + la], fv = fin[2 * W + la];
  const int32_t upper = max(max(fm, fh), fv);
  int state = fm == upper ? kMat : (fh == upper ? kHor : kVer);
  const int32_t* srow = has_seq ? seq + lane * static_cast<size_t>(LA) * LB
                                : nullptr;
  int i = la, j = lb;
  int32_t gap = 0, seq_sum = 0, n_lines = 0;
  while (i > 0 || j > 0) {
    const int st = i == 0 ? kHor : (j == 0 ? kVer : state);
    const int code = dirs[static_cast<size_t>(i + j) * W + i];
    const int pred = (code >> (2 * st)) & 3;
    if (st == kMat) {
      prow[i - 1] = j - 1;
      ++n_lines;
      if (srow != nullptr) {
        seq_sum = wadd(seq_sum, srow[static_cast<size_t>(i - 1) * LB + j - 1]);
      }
      --i;
      --j;
    } else if (st == kHor) {
      gap = wadd(gap, pred == kHor ? ge : go);
      --j;
    } else {
      gap = wadd(gap, pred == kVer ? ge : go);
      prow[i - 1] = -1;
      --i;
    }
    state = pred;
  }
  int32_t* out = scalars + lane * 4;
  out[0] = upper;
  out[1] = gap;
  out[2] = n_lines;
  out[3] = seq_sum;
}

ffi::Error GotohWavefrontImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> pssm,
                              ffi::Buffer<ffi::S32> seq,
                              ffi::Buffer<ffi::S32> la,
                              ffi::Buffer<ffi::S32> lb,
                              ffi::Buffer<ffi::S32> gaps,
                              ffi::ResultBuffer<ffi::S32> partner,
                              ffi::ResultBuffer<ffi::S32> scalars,
                              ffi::ResultBuffer<ffi::U8> dirs) {
  const auto dims = pssm.dimensions();
  if (dims.size() != 3) {
    return ffi::Error::InvalidArgument("pssm must have shape [B, LA, LB]");
  }
  const int64_t batch = dims[0], la_max = dims[1], lb_max = dims[2];
  if (la.element_count() != static_cast<size_t>(batch) ||
      lb.element_count() != static_cast<size_t>(batch) ||
      gaps.element_count() != 2) {
    return ffi::Error::InvalidArgument("la/lb must be [B] and gaps [2]");
  }
  if (batch == 0) return ffi::Error::Success();
  const int64_t width = la_max + 1;
  const int64_t cells = batch * (la_max + lb_max + 1) * width;
  const bool gmem_dirs = dirs->element_count() >= static_cast<size_t>(cells);
  const bool has_seq =
      seq.element_count() == static_cast<size_t>(batch * la_max * lb_max);
  const size_t smem =
      9 * width * sizeof(int32_t) +
      (gmem_dirs ? 0 : static_cast<size_t>((la_max + lb_max + 1) * width));

  int device = 0;
  int smem_limit = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  if (smem > static_cast<size_t>(smem_limit)) {
    return ffi::Error::InvalidArgument(
        "gotoh_wavefront: " + std::to_string(smem) +
        " bytes of shared memory per lane exceed the device limit of " +
        std::to_string(smem_limit));
  }
  auto kernel = gmem_dirs ? gotoh_wavefront_kernel<false>
                          : gotoh_wavefront_kernel<true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("gotoh_wavefront: ") +
                                cudaGetErrorString(err));
  }
  const int threads = static_cast<int>(
      std::min<int64_t>(kMaxThreads, ((width + 31) / 32) * 32));
  kernel<<<static_cast<unsigned>(batch), threads, smem, stream>>>(
      pssm.typed_data(), seq.typed_data(), la.typed_data(), lb.typed_data(),
      gaps.typed_data(), static_cast<int>(la_max), static_cast<int>(lb_max),
      has_seq, partner->typed_data(), scalars->typed_data(),
      dirs->typed_data());
  err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("gotoh_wavefront: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(LaraGotohWavefront, GotohWavefrontImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()  // pssm
                                  .Arg<ffi::Buffer<ffi::S32>>()  // seq
                                  .Arg<ffi::Buffer<ffi::S32>>()  // la
                                  .Arg<ffi::Buffer<ffi::S32>>()  // lb
                                  .Arg<ffi::Buffer<ffi::S32>>()  // gaps
                                  .Ret<ffi::Buffer<ffi::S32>>()  // partner
                                  .Ret<ffi::Buffer<ffi::S32>>()  // scalars
                                  .Ret<ffi::Buffer<ffi::U8>>());  // dirs
