// Global partial-order-alignment DP for NVIDIA GPUs (sm_90a), called
// from JAX through the XLA foreign function interface.
//
// Same recurrence, scores and tie-breaks as poa_dp_xla
// (ops/poa_device.py), which stays as the CPU path and this kernel's
// parity oracle: one thread block per problem walks the problem's
// vertices in topological order inside ONE launch, while the block's
// threads split the W = L+1 query columns.  The within-row insertion
// recurrence is solved in closed form with two block-wide prefix maxima
// (f_c[j] = max_{m<j}(h_pre[m] + e_c*m) - o_c - e_c*j).
//
// Each finished vertex row (H, E1, E2) goes to the scratch result S
// [B, V+1, 3W] in device memory; a successor reads its predecessors'
// rows back from there, which the L2 cache holds for recently written
// rows.  Row V is the virtual source (leading-insertion costs).  The
// block synchronises after every vertex, so a row is visible to every
// thread of the block before any successor reads it.  Predecessor ids
// must be strictly lower than their vertex (the host-side problem prep
// orders vertices topologically).
//
// Scores are integer-valued f32 (abPOA's default costs), so every sum
// and max is exact; build with -fmad=false all the same.
//
// Outputs match poa_dp_xla's: score [B] f32, best_sink [B] i32 and the
// packed traceback decisions tbits [B, V, W] i32 (bit layout in
// ops/poa_device.py).  tbits rows at v >= nv[b] are zero.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr float kNegF = -1.0e9f;
constexpr int kVirtSlot = 15;
constexpr int kCaseM = 0, kCaseE1 = 1, kCaseE2 = 2, kCaseF1 = 3, kCaseF2 = 4;
constexpr int kMaxThreads = 256;
constexpr int kMaxP = 8;

struct Costs {
  float match, mismatch, o1, e1, o2, e2;
};

__device__ __forceinline__ float WarpInclusiveMax(float x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    float y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x = fmaxf(x, y);
  }
  return x;
}

// Exclusive prefix max over the block's threads (thread t gets the max
// of the values of threads < t, -inf for thread 0), for two values at
// once.  `scratch` holds 2 * 32 floats.
__device__ __forceinline__ void BlockExclusiveMax2(float a, float b,
                                                   float* scratch,
                                                   float* ex_a, float* ex_b) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  float ia = WarpInclusiveMax(a, lane);
  float ib = WarpInclusiveMax(b, lane);
  if (lane == 31) {
    scratch[warp] = ia;
    scratch[32 + warp] = ib;
  }
  __syncthreads();
  if (warp == 0) {
    float wa = lane < n_warps ? scratch[lane] : -CUDART_INF_F;
    float wb = lane < n_warps ? scratch[32 + lane] : -CUDART_INF_F;
    float sa = WarpInclusiveMax(wa, lane);
    float sb = WarpInclusiveMax(wb, lane);
    // exclusive over warps: shift by one lane
    float xa = __shfl_up_sync(0xffffffffu, sa, 1);
    float xb = __shfl_up_sync(0xffffffffu, sb, 1);
    if (lane < n_warps) {
      scratch[lane] = lane == 0 ? -CUDART_INF_F : xa;
      scratch[32 + lane] = lane == 0 ? -CUDART_INF_F : xb;
    }
  }
  __syncthreads();
  float pa = __shfl_up_sync(0xffffffffu, ia, 1);
  float pb = __shfl_up_sync(0xffffffffu, ib, 1);
  if (lane == 0) {
    pa = -CUDART_INF_F;
    pb = -CUDART_INF_F;
  }
  *ex_a = fmaxf(scratch[warp], pa);
  *ex_b = fmaxf(scratch[32 + warp], pb);
}

// C query columns per thread, contiguous: thread t owns [t*C, t*C + C).
template <int C>
__global__ void PoaDpKernel(const int8_t* __restrict__ vcodes,
                            const int32_t* __restrict__ vpred,
                            const int8_t* __restrict__ is_sink,
                            const int32_t* __restrict__ nv_arr,
                            const int8_t* __restrict__ q,
                            const int32_t* __restrict__ nq_arr,
                            const float* __restrict__ init_row,
                            float* __restrict__ score_out,
                            int32_t* __restrict__ sink_out,
                            int32_t* __restrict__ tbits, float* S, int V,
                            int P, int L, Costs k) {
  __shared__ float scan_scratch[64];
  __shared__ float h_shared[kMaxThreads * C];
  __shared__ float red_val[kMaxThreads];
  __shared__ int red_idx[kMaxThreads];

  const int b = blockIdx.x;
  const int W = L + 1;
  const int j0 = threadIdx.x * C;
  const int nv = nv_arr[b];
  const int8_t* qb = q + static_cast<int64_t>(b) * L;
  const int32_t* pb = vpred + static_cast<int64_t>(b) * V * P;
  const int8_t* cb = vcodes + static_cast<int64_t>(b) * V;
  float* Sb = S + static_cast<int64_t>(b) * (V + 1) * 3 * W;
  int32_t* tb = tbits + static_cast<int64_t>(b) * V * W;
  const float oe1 = k.o1 + k.e1, oe2 = k.o2 + k.e2;

  // virtual source row V: H = leading-insertion costs, E1 = E2 = -inf
  {
    float* row = Sb + static_cast<int64_t>(V) * 3 * W;
    for (int c = 0; c < C; ++c) {
      row[j0 + c] = init_row[j0 + c];
      row[W + j0 + c] = kNegF;
      row[2 * W + j0 + c] = kNegF;
    }
  }
  // this thread's query codes: column j pairs vertex v with q[j-1]
  int8_t qc[C];
  for (int c = 0; c < C; ++c) {
    int j = j0 + c;
    qc[c] = j >= 1 ? qb[j - 1] : 4;
  }
  __syncthreads();

  for (int v = 0; v < nv; ++v) {
    int preds[kMaxP];
    for (int p = 0; p < P; ++p) preds[p] = pb[static_cast<int64_t>(v) * P + p];
    const bool has_any = preds[0] >= 0;
    const int vcode = cb[v];

    float h_pre[C], best1[C], best2[C];
    int case_pre[C], slot1[C], slot2[C], m_slot[C], opn1[C], opn2[C];
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      float b1 = 0.f, b2 = 0.f, mb = 0.f;
      int s1 = 0, s2 = 0, ms = 0, o1f = 0, o2f = 0;
      for (int p = 0; p < P; ++p) {
        const bool pred_live = preds[p] >= 0;
        const bool live = pred_live || (p == 0 && !has_any);
        const int idx = pred_live ? preds[p] : V;
        const float* row = Sb + static_cast<int64_t>(idx) * 3 * W;
        const float hp = live ? row[j] : kNegF;
        const float e1p = pred_live ? row[W + j] : kNegF;
        const float e2p = pred_live ? row[2 * W + j] : kNegF;
        const float open1 = hp - oe1, ext1 = e1p - k.e1;
        const float open2 = hp - oe2, ext2 = e2p - k.e2;
        const float cand1 = fmaxf(open1, ext1), cand2 = fmaxf(open2, ext2);
        float mc = kNegF;
        if (j >= 1) {
          const int qv = qc[c];
          float sub = (qv == vcode) ? k.match : k.mismatch;
          if (qv >= 4 || vcode >= 4) sub = k.mismatch;
          const float hprev = live ? row[j - 1] : kNegF;
          mc = hprev + sub;
        }
        // first slot reaching the column max (argmax tie rule)
        if (p == 0 || cand1 > b1) { b1 = cand1; s1 = p; o1f = open1 >= ext1; }
        if (p == 0 || cand2 > b2) { b2 = cand2; s2 = p; o2f = open2 >= ext2; }
        if (p == 0 || mc > mb) { mb = mc; ms = p; }
      }
      // stored slots: 15 = the virtual source (a vertex without preds)
      m_slot[c] = preds[ms] >= 0 ? ms : kVirtSlot;
      slot1[c] = preds[s1] >= 0 ? s1 : kVirtSlot;
      slot2[c] = preds[s2] >= 0 ? s2 : kVirtSlot;
      opn1[c] = o1f;
      opn2[c] = o2f;
      best1[c] = b1;
      best2[c] = b2;
      const float be = fmaxf(b1, b2);
      h_pre[c] = fmaxf(mb, be);
      case_pre[c] = mb >= be ? kCaseM : (b1 >= b2 ? kCaseE1 : kCaseE2);
    }

    // closed-form in-row insertions: ex_c[j] = max_{m<j}(h_pre[m] + e_c*m)
    float tot1 = -CUDART_INF_F, tot2 = -CUDART_INF_F;
    for (int c = 0; c < C; ++c) {
      const float jf = static_cast<float>(j0 + c);
      tot1 = fmaxf(tot1, h_pre[c] + k.e1 * jf);
      tot2 = fmaxf(tot2, h_pre[c] + k.e2 * jf);
    }
    float ex1, ex2;
    BlockExclusiveMax2(tot1, tot2, scan_scratch, &ex1, &ex2);

    float h_row[C], f1[C], f2[C];
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      const float jf = static_cast<float>(j);
      f1[c] = j == 0 ? kNegF : (ex1 - k.o1) - k.e1 * jf;
      f2[c] = j == 0 ? kNegF : (ex2 - k.o2) - k.e2 * jf;
      h_row[c] = fmaxf(h_pre[c], fmaxf(f1[c], f2[c]));
      ex1 = fmaxf(ex1, h_pre[c] + k.e1 * jf);
      ex2 = fmaxf(ex2, h_pre[c] + k.e2 * jf);
      h_shared[j] = h_row[c];
    }
    __syncthreads();

    float* out = Sb + static_cast<int64_t>(v) * 3 * W;
    int32_t* tout = tb + static_cast<int64_t>(v) * W;
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      const float prev_h = j == 0 ? kNegF : h_shared[j - 1];
      const int cs = h_row[c] <= h_pre[c]
                         ? case_pre[c]
                         : (h_row[c] == f1[c] ? kCaseF1 : kCaseF2);
      const int f1_open = f1[c] == prev_h - oe1;
      const int f2_open = f2[c] == prev_h - oe2;
      tout[j] = cs | (m_slot[c] << 3) | (opn1[c] << 7) | (slot1[c] << 8) |
                (opn2[c] << 12) | (slot2[c] << 13) | (f1_open << 17) |
                (f2_open << 18);
      out[j] = h_row[c];
      out[W + j] = best1[c];
      out[2 * W + j] = best2[c];
    }
    // the row is complete and visible before any successor reads it,
    // and h_shared is free for the next vertex
    __syncthreads();
  }

  for (int64_t i = static_cast<int64_t>(nv) * W + threadIdx.x;
       i < static_cast<int64_t>(V) * W; i += blockDim.x) {
    tb[i] = 0;
  }

  // best sink at column nq: first vertex in topological order on ties
  const int nq = nq_arr[b];
  float bv = -CUDART_INF_F;
  int bi = V;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    const bool sink = is_sink[static_cast<int64_t>(b) * V + v] != 0 && v < nv;
    const float s = sink ? Sb[static_cast<int64_t>(v) * 3 * W + nq] : kNegF;
    if (s > bv) {
      bv = s;
      bi = v;
    }
  }
  red_val[threadIdx.x] = bv;
  red_idx[threadIdx.x] = bi;
  __syncthreads();
  for (int stride = blockDim.x / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      const float ov = red_val[threadIdx.x + stride];
      const int oi = red_idx[threadIdx.x + stride];
      if (ov > red_val[threadIdx.x] ||
          (ov == red_val[threadIdx.x] && oi < red_idx[threadIdx.x])) {
        red_val[threadIdx.x] = ov;
        red_idx[threadIdx.x] = oi;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    score_out[b] = red_val[0];
    sink_out[b] = red_idx[0];
  }
}

template <int C>
void Launch(cudaStream_t stream, int B, int threads, const int8_t* vcodes,
            const int32_t* vpred, const int8_t* is_sink, const int32_t* nv,
            const int8_t* q, const int32_t* nq, const float* init_row,
            float* score, int32_t* sink, int32_t* tbits, float* S, int V,
            int P, int L, Costs k) {
  PoaDpKernel<C><<<B, threads, 0, stream>>>(vcodes, vpred, is_sink, nv, q,
                                            nq, init_row, score, sink, tbits,
                                            S, V, P, L, k);
}

ffi::Error PoaDpImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> vcodes,
                     ffi::Buffer<ffi::S32> vpred,
                     ffi::Buffer<ffi::S8> is_sink, ffi::Buffer<ffi::S32> nv,
                     ffi::Buffer<ffi::S8> q, ffi::Buffer<ffi::S32> nq,
                     ffi::Buffer<ffi::F32> init_row, float match,
                     float mismatch, float gap_open1, float gap_ext1,
                     float gap_open2, float gap_ext2,
                     ffi::ResultBuffer<ffi::F32> score,
                     ffi::ResultBuffer<ffi::S32> best_sink,
                     ffi::ResultBuffer<ffi::S32> tbits,
                     ffi::ResultBuffer<ffi::F32> scratch) {
  auto pd = vpred.dimensions();
  if (pd.size() != 3) {
    return ffi::Error(ffi::ErrorCode::kInvalidArgument, "vpred must be [B,V,P]");
  }
  const int B = static_cast<int>(pd[0]);
  const int V = static_cast<int>(pd[1]);
  const int P = static_cast<int>(pd[2]);
  const int L = static_cast<int>(q.dimensions()[1]);
  const int W = L + 1;
  if (P < 1 || P > kMaxP) {
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "predecessor slots must be 1..8");
  }
  int C = 1;
  while (W / C > kMaxThreads) C <<= 1;
  const int threads = W / C;
  if (W % C != 0 || threads % 32 != 0 || C > 16) {
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "W = L+1 must be a multiple of 32 and at most 4096");
  }
  if (B == 0) return ffi::Error::Success();
  Costs k{match, mismatch, gap_open1, gap_ext1, gap_open2, gap_ext2};
#define VG_LAUNCH(CC)                                                        \
  Launch<CC>(stream, B, threads, vcodes.typed_data(), vpred.typed_data(),  \
             is_sink.typed_data(), nv.typed_data(), q.typed_data(),        \
             nq.typed_data(), init_row.typed_data(), score->typed_data(),  \
             best_sink->typed_data(), tbits->typed_data(),                 \
             scratch->typed_data(), V, P, L, k)
  switch (C) {
    case 1: VG_LAUNCH(1); break;
    case 2: VG_LAUNCH(2); break;
    case 4: VG_LAUNCH(4); break;
    case 8: VG_LAUNCH(8); break;
    default: VG_LAUNCH(16); break;
  }
#undef VG_LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error(ffi::ErrorCode::kInternal, cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(VgPoaDp, PoaDpImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()   // vcodes
                                  .Arg<ffi::Buffer<ffi::S32>>()  // vpred
                                  .Arg<ffi::Buffer<ffi::S8>>()   // is_sink
                                  .Arg<ffi::Buffer<ffi::S32>>()  // nv
                                  .Arg<ffi::Buffer<ffi::S8>>()   // q
                                  .Arg<ffi::Buffer<ffi::S32>>()  // nq
                                  .Arg<ffi::Buffer<ffi::F32>>()  // init_row
                                  .Attr<float>("match")
                                  .Attr<float>("mismatch")
                                  .Attr<float>("gap_open1")
                                  .Attr<float>("gap_ext1")
                                  .Attr<float>("gap_open2")
                                  .Attr<float>("gap_ext2")
                                  .Ret<ffi::Buffer<ffi::F32>>()   // score
                                  .Ret<ffi::Buffer<ffi::S32>>()   // best_sink
                                  .Ret<ffi::Buffer<ffi::S32>>()   // tbits
                                  .Ret<ffi::Buffer<ffi::F32>>());  // scratch S
