// Two-strand Myers/Hyyro HW (infix) edit distance of one query against a
// batch of targets, as an XLA FFI custom call for NVIDIA GPUs.
//
// One warp scores one (target row, strand) pair and walks the whole row
// with the query's bit state in registers: lane l owns the K consecutive
// 32-bit words [K*l, K*l + K) of the W-word vp/vn vectors. Per column:
//   - eq is selected from the lane's peq words by the text character;
//   - the multiword add (eq & vp) + vp ripples inside the lane, and the
//     carry between lanes is resolved from two warp ballots (generate /
//     propagate bits), added as a 32-bit carry-lookahead;
//   - the shift-by-one of hp/hn passes each lane's top bits up one lane
//     with a single shuffle;
//   - the lane owning query row m-1 tracks score, best and its column.
// The text row is staged through shared memory 512 bytes at a time and
// every warp stops at its own row length, so padding costs no columns.
// Semantics match ops/myers.myers_distance_batch (mode HW, collect best):
// dist = min over columns of the last-row score (m when no column beats
// the empty alignment), end = first column reaching it, or -1.
//
// Build: see ops/myers_cuda.build_kernels (nvcc, sm_90).

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarpsPerBlock = 2;     // the two strands of one row
constexpr int kStage = 512;           // text bytes staged per refill
constexpr int kMaxWordsPerLane = 8;   // query up to 32 * 32 * 8 = 8192

template <int K>
__global__ void MyersHw2StrandKernel(const uint32_t* __restrict__ peq,
                                     const int8_t* __restrict__ text,
                                     const int32_t* __restrict__ lens,
                                     int B, int L, int W, int m,
                                     int32_t* __restrict__ dist,
                                     int32_t* __restrict__ end) {
  __shared__ alignas(16) int8_t stage[kWarpsPerBlock][kStage];
  const int lane = threadIdx.x & 31;
  const int strand = threadIdx.x >> 5;
  const int row = blockIdx.x;
  if (row >= B) return;

  // peq layout (2, 5, W): strand, character, word
  const uint32_t* q = peq + (size_t)strand * 5 * W;
  uint32_t p0[K], p1[K], p2[K], p3[K], vp[K], vn[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int w = lane * K + k;
    const bool in = w < W;
    p0[k] = in ? q[0 * W + w] : 0u;
    p1[k] = in ? q[1 * W + w] : 0u;
    p2[k] = in ? q[2 * W + w] : 0u;
    p3[k] = in ? q[3 * W + w] : 0u;
    vp[k] = kFull;
    vn[k] = 0u;
  }

  const int hw_word = (m - 1) >> 5;
  const int owner = hw_word / K;
  const int kk = hw_word % K;
  const uint32_t hb = (uint32_t)((m - 1) & 31);
  int score = m, best = m, bestj = -1;

  int len = lens[row];
  len = len < 0 ? 0 : (len > L ? L : len);
  const int8_t* trow = text + (size_t)row * L;
  int8_t* buf = stage[strand];

  for (int base = 0; base < len; base += kStage) {
    __syncwarp();
    const int off = base + lane * 16;
    if (off < L) {
      *reinterpret_cast<int4*>(buf + lane * 16) =
          *reinterpret_cast<const int4*>(trow + off);
    }
    __syncwarp();
    const int n = min(kStage, len - base);
    for (int t = 0; t < n; ++t) {
      const uint32_t c = (uint8_t)buf[t];
      const bool b0 = c & 1u, b1 = c & 2u, valid = c < 4u;
      uint32_t eq[K], s[K];
      uint32_t carry = 0u;
      bool ones = true;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const uint32_t t01 = b0 ? p1[k] : p0[k];
        const uint32_t t23 = b0 ? p3[k] : p2[k];
        eq[k] = valid ? (b1 ? t23 : t01) : 0u;
        const uint32_t x = eq[k] & vp[k];
        const uint32_t t1 = x + vp[k];
        const uint32_t t2 = t1 + carry;
        carry = (uint32_t)(t1 < x) | (uint32_t)(t2 < t1);
        s[k] = t2;
        ones = ones && (t2 == kFull);
      }
      // carry into each lane: lane words are digits of a 32-digit number
      // whose generate/propagate bits come from the ballots (exclusive: a
      // lane that overflowed cannot sum to all ones)
      const unsigned g = __ballot_sync(kFull, carry);
      const unsigned pr = __ballot_sync(kFull, ones);
      const unsigned a = g | pr;
      uint32_t cin = (((a + g) ^ a ^ g) >> lane) & 1u;
      uint32_t d0[K], hp[K], hn[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const uint32_t sk = s[k] + cin;
        cin &= (uint32_t)(s[k] == kFull);
        d0[k] = (sk ^ vp[k]) | eq[k] | vn[k];
        hp[k] = vn[k] | ~(d0[k] | vp[k]);
        hn[k] = vp[k] & d0[k];
      }
      uint32_t hpw = 0u, hnw = 0u;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k == kk) {
          hpw = hp[k];
          hnw = hn[k];
        }
      }
      score += (int)((hpw >> hb) & 1u) - (int)((hnw >> hb) & 1u);
      const int j = base + t;
      if (score < best) {
        best = score;
        bestj = j;
      }
      // HW mode: nothing enters bit 0 of word 0 (free start in the text)
      const uint32_t top = (hp[K - 1] >> 31) | ((hn[K - 1] >> 31) << 1);
      uint32_t below = __shfl_up_sync(kFull, top, 1);
      if (lane == 0) below = 0u;
#pragma unroll
      for (int k = K - 1; k >= 0; --k) {
        const uint32_t in_p = k ? (hp[k - 1] >> 31) : (below & 1u);
        const uint32_t in_n = k ? (hn[k - 1] >> 31) : (below >> 1);
        const uint32_t hps = (hp[k] << 1) | in_p;
        const uint32_t hns = (hn[k] << 1) | in_n;
        vp[k] = hns | ~(d0[k] | hps);
        vn[k] = hps & d0[k];
      }
    }
  }
  if (lane == owner) {
    dist[(size_t)strand * B + row] = best;
    end[(size_t)strand * B + row] = bestj;
  }
}

template <int K>
void Launch(cudaStream_t stream, const uint32_t* peq, const int8_t* text,
            const int32_t* lens, int B, int L, int W, int m, int32_t* dist,
            int32_t* end) {
  MyersHw2StrandKernel<K><<<B, 32 * kWarpsPerBlock, 0, stream>>>(
      peq, text, lens, B, L, W, m, dist, end);
}

ffi::Error MyersHw2StrandImpl(cudaStream_t stream,
                              ffi::Buffer<ffi::U32> peq,
                              ffi::Buffer<ffi::S8> text,
                              ffi::Buffer<ffi::S32> lens, int32_t m,
                              ffi::ResultBuffer<ffi::S32> dist,
                              ffi::ResultBuffer<ffi::S32> end) {
  const auto pd = peq.dimensions();
  const auto td = text.dimensions();
  if (pd.size() != 3 || pd[0] != 2 || pd[1] != 5 || td.size() != 2) {
    return ffi::Error::InvalidArgument("peq must be (2, 5, W), text (B, L)");
  }
  const int W = (int)pd[2];
  const int B = (int)td[0];
  const int L = (int)td[1];
  if (m < 1 || (m + 31) / 32 != W) {
    return ffi::Error::InvalidArgument("m does not match the peq width");
  }
  if (L % 16 != 0) {
    return ffi::Error::InvalidArgument("text length must be a multiple of 16");
  }
  if (B == 0) return ffi::Error::Success();
  const int K = (W + 31) / 32;
  const uint32_t* p = peq.typed_data();
  const int8_t* t = text.typed_data();
  const int32_t* n = lens.typed_data();
  int32_t* d = dist->typed_data();
  int32_t* e = end->typed_data();
  switch (K) {
    case 1: Launch<1>(stream, p, t, n, B, L, W, m, d, e); break;
    case 2: Launch<2>(stream, p, t, n, B, L, W, m, d, e); break;
    case 3: Launch<3>(stream, p, t, n, B, L, W, m, d, e); break;
    case 4: Launch<4>(stream, p, t, n, B, L, W, m, d, e); break;
    case 5: Launch<5>(stream, p, t, n, B, L, W, m, d, e); break;
    case 6: Launch<6>(stream, p, t, n, B, L, W, m, d, e); break;
    case 7: Launch<7>(stream, p, t, n, B, L, W, m, d, e); break;
    case 8: Launch<8>(stream, p, t, n, B, L, W, m, d, e); break;
    default:
      return ffi::Error::InvalidArgument(
          "query longer than " + std::to_string(32 * 32 * kMaxWordsPerLane));
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(CfMyersHw2Strand, MyersHw2StrandImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("m")
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());
