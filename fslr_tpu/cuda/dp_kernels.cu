// Dynamic-programming kernels for NVIDIA Hopper (sm_90a), called from JAX
// through the XLA foreign function interface (fslr_tpu/ops/cuda.py).
//
// One warp owns one DP row (one candidate, one read, one window).  The
// 128 DP lanes of the plain JAX path live 4 per thread: cell c = 4*lane+k.
// Moves across a thread boundary are one warp shuffle, and the lazy-F lane
// prefix-max (ops/ssw.py module docstring) is an in-thread scan of 4 cells
// followed by a 5-step shuffle scan.  Every DP value is integer-valued and
// far below 2^24, so int32 arithmetic reproduces the float32 plain path
// exactly; NEG plays the role of the plain path's -1e30.
//
//   fslr_banded_score  banded affine SW, score / end cell per row
//                      (ops/banded.py _banded_jax)
//   fslr_banded_extend banded SW emitting 4-bit traceback codes, then the
//                      path walk emitting the 2-bit op stream
//                      (ops/traceback.py _tb_jax + _walk_device)
//   fslr_sw            batched SW, query on the lanes (ops/ssw.py _sw_jax)
//   fslr_sw_packed     lane-packed primer SW with segment isolation
//                      (ops/ssw.py _sw_packed_jax)

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNeg = -(1 << 28);
constexpr int kSegBig = 1000000;      // ops/ssw.py SEG_BIG
constexpr int kBigIdx = 1 << 30;

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = imax(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = imin(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

// Exclusive prefix max over the warp's 128 cells; kNeg at cell 0.
__device__ __forceinline__ void cummax_excl(const int c[4], int out[4],
                                            int lane) {
  const int p0 = c[0];
  const int p1 = imax(p0, c[1]);
  const int p2 = imax(p1, c[2]);
  int t = imax(p2, c[3]);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, t, d);
    if (lane >= d) t = imax(t, u);
  }
  int ex = __shfl_up_sync(kFull, t, 1);
  if (lane == 0) ex = kNeg;
  out[0] = ex;
  out[1] = imax(ex, p0);
  out[2] = imax(ex, p1);
  out[3] = imax(ex, p2);
}

// Copy one row of n code bytes into this warp's shared-memory slice.
__device__ __forceinline__ void load_row(uint8_t* dst, const uint8_t* src,
                                         int n, int lane) {
  if ((n & 3) == 0) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    for (int j = lane; j < (n >> 2); j += 32) d[j] = s[j];
  } else {
    for (int j = lane; j < n; j += 32) dst[j] = src[j];
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// Banded SW in band space: cell (i, l) covers window[i + l]; the diagonal
// predecessor is the same cell, the query-gap predecessor is cell l+1.
// ---------------------------------------------------------------------------

template <bool kEmit>
__global__ void band_kernel(const uint8_t* __restrict__ q,
                            const uint8_t* __restrict__ w,
                            const int32_t* __restrict__ qlens, int n_rows,
                            int lq, int match, int mismatch, int fg, int ext,
                            int32_t* __restrict__ out,
                            int32_t* __restrict__ bits) {
  extern __shared__ uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= n_rows) return;
  const int wl = lq + 256;
  uint8_t* sq = smem + static_cast<size_t>(warp) * (lq + wl);
  uint8_t* sw = sq + lq;
  load_row(sq, q + static_cast<size_t>(row) * lq, lq, lane);
  load_row(sw, w + static_cast<size_t>(row) * wl, wl, lane);

  const int qlen = qlens[row];
  int n_steps = imin(imax(qlen, 0), lq);
  // the walk of a row with no alignment starts (and stops) at cell (0, 0)
  if (kEmit) n_steps = imax(n_steps, 1);
  const int c0 = 4 * lane;
  int H[4], E[4], bH[4], bI[4], pack[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    H[k] = 0;
    E[k] = kNeg;
    bH[k] = kNeg;
    bI[k] = 0;
    pack[k] = 0;
  }
  const size_t bits_row = static_cast<size_t>(row) * (lq / 8);

  for (int i = 0; i < n_steps; ++i) {
    const int qc = sq[i];
    int hn = __shfl_down_sync(kFull, H[0], 1);
    int en = __shfl_down_sync(kFull, E[0], 1);
    if (lane == 31) {
      hn = kNeg;
      en = kNeg;
    }
    const int Hup[4] = {H[1], H[2], H[3], hn};
    const int Eup[4] = {E[1], E[2], E[3], en};
    int En[4], diag[4], Hno[4], C[4], Cm[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int wc = sw[i + c0 + k];
      const int s = (wc == qc && qc < 4 && wc < 4) ? match : mismatch;
      En[k] = imax(Eup[k] - ext, Hup[k] - fg);
      diag[k] = H[k] + s;
      Hno[k] = imax(imax(diag[k], En[k]), 0);
      C[k] = Hno[k] + (c0 + k) * ext;
    }
    cummax_excl(C, Cm, lane);
    int cprev = 0;
    if (kEmit) {
      cprev = __shfl_up_sync(kFull, C[3], 1);
      if (lane == 0) cprev = kNeg;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int F = Cm[k] - fg - (c0 + k - 1) * ext;
      const int hnew = imax(Hno[k], F);
      if (kEmit) {
        const int cp = k ? C[k - 1] : cprev;
        const bool e_ext = (Eup[k] - ext) >= (Hup[k] - fg);
        const bool f_ext = Cm[k] > cp;
        const int src = (F > Hno[k]) ? 3
                        : (diag[k] == Hno[k] && Hno[k] > 0) ? 1
                        : (En[k] == Hno[k] && Hno[k] > 0) ? 2 : 0;
        const int code = src + (e_ext ? 4 : 0) + (f_ext ? 8 : 0);
        pack[k] |= code << (4 * (i & 7));
      }
      H[k] = hnew;
      E[k] = En[k];
      if (hnew > bH[k] && i < qlen) {
        bH[k] = hnew;
        bI[k] = i;
      }
    }
    if (kEmit && ((i & 7) == 7 || i == n_steps - 1)) {
      reinterpret_cast<int4*>(bits + (bits_row + (i >> 3)) * 128)[lane] =
          make_int4(pack[0], pack[1], pack[2], pack[3]);
#pragma unroll
      for (int k = 0; k < 4; ++k) pack[k] = 0;
    }
  }

  int m = imax(imax(bH[0], bH[1]), imax(bH[2], bH[3]));
  m = warp_max(m);
  int lbest = kBigIdx, qbest = kBigIdx;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (bH[k] == m) {
      lbest = imin(lbest, c0 + k);
      qbest = imin(qbest, bI[k]);
    }
  }
  lbest = warp_min(lbest);
  qbest = warp_min(qbest);
  if (lane == 0) {
    const int score = imax(m, 0);
    const bool none = score <= 0;
    out[3 * row + 0] = score;
    out[3 * row + 1] = none ? 0 : qbest;
    out[3 * row + 2] = none ? 0 : lbest;
  }
}

// Path walk over the emitted codes, one thread per row: the state machine
// of ops/traceback.py _walk_device, writing the 2-bit packed op stream
// (0/1/2 = M/I/D, 3 = no op) and [score, qend, lane, i_fin+1, l_fin, n_ops].
__global__ void walk_kernel(const int32_t* __restrict__ bits,
                            const int32_t* __restrict__ ends, int n_rows,
                            int lq, int t_steps, int32_t* __restrict__ res,
                            uint8_t* __restrict__ emits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const int32_t* b = bits + static_cast<size_t>(row) * (lq / 8) * 128;
  uint8_t* e = emits + static_cast<size_t>(row) * (t_steps / 4);
  int i = ends[3 * row + 1];
  int l = ends[3 * row + 2];
  int st = 0;
  bool active = true;
  int n_ops = 0;
  int acc = 0;
  int t = 0;
  for (; t < t_steps && active; ++t) {
    const int ii = imin(imax(i, 0), lq - 1);
    const int ll = imin(imax(l, 0), 127);
    const int word = b[(ii >> 3) * 128 + ll];
    const int code = (word >> ((ii & 7) * 4)) & 15;
    const int src = code & 3;
    const bool e_ext = (code & 4) != 0;
    const bool f_ext = (code & 8) != 0;
    const bool is_h = st == 0;
    const bool stop = is_h && src == 0;
    const bool diag = is_h && src == 1;
    const bool to_e = is_h && src == 2;
    const bool to_f = is_h && src == 3;
    const bool in_e = st == 1;
    const bool in_f = st == 2;
    const int op = diag ? 0 : in_e ? 1 : in_f ? 2 : 3;
    if (op != 3) ++n_ops;
    if (to_e) st = 1;
    if (to_f) st = 2;
    if ((in_e && !e_ext) || (in_f && !f_ext)) st = 0;
    i -= (diag || in_e) ? 1 : 0;
    l += (in_e ? 1 : 0) - (in_f ? 1 : 0);
    active = !stop && i >= 0;
    acc |= op << (2 * (t & 3));
    if ((t & 3) == 3) {
      e[t >> 2] = static_cast<uint8_t>(acc);
      acc = 0;
    }
  }
  for (; t < t_steps; ++t) {
    acc |= 3 << (2 * (t & 3));
    if ((t & 3) == 3) {
      e[t >> 2] = static_cast<uint8_t>(acc);
      acc = 0;
    }
  }
  int32_t* r = res + 6 * static_cast<size_t>(row);
  r[0] = ends[3 * row];
  r[1] = ends[3 * row + 1];
  r[2] = ends[3 * row + 2];
  r[3] = i + 1;
  r[4] = l;
  r[5] = n_ops;
}

// ---------------------------------------------------------------------------
// Batched SW with query positions on the lanes; target rows are scanned.
// kPacked: several primers per row at a fixed lane stride, isolated by a
// diagonal reset at segment starts and a SEG_BIG offset in the prefix-max.
// ---------------------------------------------------------------------------

template <bool kPacked>
__global__ void sw_kernel(const uint8_t* __restrict__ q,
                          const uint8_t* __restrict__ t,
                          const int32_t* __restrict__ qlens,
                          const int32_t* __restrict__ tlens, int n_rows,
                          int tl, int match, int mismatch, int fg, int ext,
                          int stride, float* __restrict__ score_out,
                          int32_t* __restrict__ tend_out,
                          int32_t* __restrict__ qend_out) {
  extern __shared__ uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= n_rows) return;
  uint8_t* st = smem + static_cast<size_t>(warp) * tl;
  load_row(st, t + static_cast<size_t>(row) * tl, tl, lane);

  const int c0 = 4 * lane;
  const int qlen = kPacked ? 128 : qlens[row];
  const int n_steps = imin(imax(tlens[row], 0), tl);
  int qv[4], seg[4];
  bool valid[4], seg_start[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = c0 + k;
    qv[k] = q[static_cast<size_t>(row) * 128 + c];
    valid[k] = kPacked ? (qv[k] < 4) : (c < qlen);
    seg[k] = kPacked ? c / stride : 0;
    seg_start[k] = kPacked && (c % stride == 0);
  }
  int H[4], E[4], bH[4], bI[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    H[k] = 0;
    E[k] = kNeg;
    bH[k] = kNeg;
    bI[k] = 0;
  }
  for (int i = 0; i < n_steps; ++i) {
    const int tc = st[i];
    int h3 = __shfl_up_sync(kFull, H[3], 1);
    if (lane == 0) h3 = 0;
    const int dg[4] = {h3, H[0], H[1], H[2]};
    int Hno[4], C[4], Cm[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      E[k] = imax(E[k] - ext, H[k] - fg);
      int s = kNeg;
      if (valid[k]) {
        const bool eq = qv[k] == tc && qv[k] < 4 && tc < 4;
        s = eq ? match : mismatch;
      }
      const int d = (kPacked && seg_start[k]) ? 0 : dg[k];
      Hno[k] = imax(imax(d + s, E[k]), 0);
      C[k] = Hno[k] + (c0 + k) * ext + seg[k] * kSegBig;
    }
    cummax_excl(C, Cm, lane);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int F = Cm[k] - seg[k] * kSegBig - fg - (c0 + k - 1) * ext;
      H[k] = imax(Hno[k], F);
      if (H[k] > bH[k] && valid[k]) {
        bH[k] = H[k];
        bI[k] = i;
      }
    }
  }
  int bh[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) bh[k] = valid[k] ? bH[k] : kNeg;
  int m = warp_max(imax(imax(bh[0], bh[1]), imax(bh[2], bh[3])));
  int qbest = kBigIdx, tbest = kBigIdx;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (bh[k] == m) {
      qbest = imin(qbest, c0 + k);
      tbest = imin(tbest, bI[k]);
    }
  }
  qbest = warp_min(qbest);
  tbest = warp_min(tbest);
  if (lane == 0) {
    const int score = imax(m, 0);
    const bool none = score <= 0;
    score_out[row] = static_cast<float>(score);
    tend_out[row] = none ? 0 : tbest;
    qend_out[row] = none ? 0 : qbest;
  }
}

// ---------------------------------------------------------------------------
// FFI handlers
// ---------------------------------------------------------------------------

ffi::Error launch_status() {
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(e));
  return ffi::Error::Success();
}

template <typename Kernel>
ffi::Error set_smem(Kernel kernel, size_t smem) {
  if (smem > 227 * 1024) {
    return ffi::Error::InvalidArgument("row too long for shared memory");
  }
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(e));
  return ffi::Error::Success();
}

ffi::Error BandedScoreImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> q,
                           ffi::Buffer<ffi::U8> w,
                           ffi::Buffer<ffi::S32> qlens,
                           ffi::ResultBuffer<ffi::S32> out, int32_t match,
                           int32_t mismatch, int32_t fg, int32_t ext,
                           int32_t warps) {
  const int n = static_cast<int>(q.dimensions()[0]);
  const int lq = static_cast<int>(q.dimensions()[1]);
  if (w.dimensions()[1] != lq + 256) {
    return ffi::Error::InvalidArgument("window width must be Lq + 256");
  }
  if (n == 0) return ffi::Error::Success();
  const size_t smem = static_cast<size_t>(warps) * (2 * lq + 256);
  ffi::Error err = set_smem(band_kernel<false>, smem);
  if (err.failure()) return err;
  band_kernel<false><<<(n + warps - 1) / warps, warps * 32, smem, stream>>>(
      q.typed_data(), w.typed_data(), qlens.typed_data(), n, lq, match,
      mismatch, fg, ext, out->typed_data(), nullptr);
  return launch_status();
}

ffi::Error BandedExtendImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> q,
                            ffi::Buffer<ffi::U8> w,
                            ffi::Buffer<ffi::S32> qlens,
                            ffi::ResultBuffer<ffi::S32> res,
                            ffi::ResultBuffer<ffi::U8> emits,
                            ffi::ResultBuffer<ffi::S32> ends,
                            ffi::ResultBuffer<ffi::S32> bits, int32_t match,
                            int32_t mismatch, int32_t fg, int32_t ext,
                            int32_t warps) {
  const int n = static_cast<int>(q.dimensions()[0]);
  const int lq = static_cast<int>(q.dimensions()[1]);
  if (w.dimensions()[1] != lq + 256 || lq % 8 != 0) {
    return ffi::Error::InvalidArgument(
        "window width must be Lq + 256 and Lq a multiple of 8");
  }
  if (n == 0) return ffi::Error::Success();
  const int t_steps = lq + 128;
  const size_t smem = static_cast<size_t>(warps) * (2 * lq + 256);
  ffi::Error err = set_smem(band_kernel<true>, smem);
  if (err.failure()) return err;
  band_kernel<true><<<(n + warps - 1) / warps, warps * 32, smem, stream>>>(
      q.typed_data(), w.typed_data(), qlens.typed_data(), n, lq, match,
      mismatch, fg, ext, ends->typed_data(), bits->typed_data());
  err = launch_status();
  if (err.failure()) return err;
  walk_kernel<<<(n + 127) / 128, 128, 0, stream>>>(
      bits->typed_data(), ends->typed_data(), n, lq, t_steps,
      res->typed_data(), emits->typed_data());
  return launch_status();
}

template <bool kPacked>
ffi::Error SwLaunch(cudaStream_t stream, ffi::Buffer<ffi::U8> q,
                    ffi::Buffer<ffi::U8> t, const int32_t* qlens,
                    ffi::Buffer<ffi::S32> tlens,
                    ffi::ResultBuffer<ffi::F32> score,
                    ffi::ResultBuffer<ffi::S32> tend,
                    ffi::ResultBuffer<ffi::S32> qend, int32_t match,
                    int32_t mismatch, int32_t fg, int32_t ext, int32_t stride,
                    int32_t warps) {
  const int n = static_cast<int>(t.dimensions()[0]);
  const int tl = static_cast<int>(t.dimensions()[1]);
  if (q.dimensions()[1] != 128) {
    return ffi::Error::InvalidArgument("queries must be padded to 128 lanes");
  }
  if (n == 0) return ffi::Error::Success();
  const size_t smem = static_cast<size_t>(warps) * tl;
  ffi::Error err = set_smem(sw_kernel<kPacked>, smem);
  if (err.failure()) return err;
  sw_kernel<kPacked><<<(n + warps - 1) / warps, warps * 32, smem, stream>>>(
      q.typed_data(), t.typed_data(), qlens, tlens.typed_data(), n, tl, match,
      mismatch, fg, ext, stride, score->typed_data(), tend->typed_data(),
      qend->typed_data());
  return launch_status();
}

ffi::Error SwImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> q,
                  ffi::Buffer<ffi::U8> t, ffi::Buffer<ffi::S32> qlens,
                  ffi::Buffer<ffi::S32> tlens,
                  ffi::ResultBuffer<ffi::F32> score,
                  ffi::ResultBuffer<ffi::S32> tend,
                  ffi::ResultBuffer<ffi::S32> qend, int32_t match,
                  int32_t mismatch, int32_t fg, int32_t ext, int32_t warps) {
  return SwLaunch<false>(stream, q, t, qlens.typed_data(), tlens, score, tend,
                         qend, match, mismatch, fg, ext, 128, warps);
}

ffi::Error SwPackedImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> q,
                        ffi::Buffer<ffi::U8> t, ffi::Buffer<ffi::S32> tlens,
                        ffi::ResultBuffer<ffi::F32> score,
                        ffi::ResultBuffer<ffi::S32> tend,
                        ffi::ResultBuffer<ffi::S32> qend, int32_t match,
                        int32_t mismatch, int32_t fg, int32_t ext,
                        int32_t stride, int32_t warps) {
  return SwLaunch<true>(stream, q, t, nullptr, tlens, score, tend, qend,
                        match, mismatch, fg, ext, stride, warps);
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(FslrBandedScore, BandedScoreImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mismatch")
                                  .Attr<int32_t>("fg")
                                  .Attr<int32_t>("ext")
                                  .Attr<int32_t>("warps"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(FslrBandedExtend, BandedExtendImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mismatch")
                                  .Attr<int32_t>("fg")
                                  .Attr<int32_t>("ext")
                                  .Attr<int32_t>("warps"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(FslrSw, SwImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mismatch")
                                  .Attr<int32_t>("fg")
                                  .Attr<int32_t>("ext")
                                  .Attr<int32_t>("warps"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(FslrSwPacked, SwPackedImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mismatch")
                                  .Attr<int32_t>("fg")
                                  .Attr<int32_t>("ext")
                                  .Attr<int32_t>("stride")
                                  .Attr<int32_t>("warps"));
