// One ADRA access over two packed bit-plane stacks: any subset of the CiM op
// catalogue (repro_torch/cim/opset.py::ALL_OPS) from ONE pass over the planes.
//
// Replaces the TPU kernel src/repro/cim/fused_kernel.py::_fused_kernel
// (pallas_call at line 137, reached through fused_planes_op). Bit-exact with
// it and with the plain PyTorch version fused_planes_op_ref beside the
// wrapper in repro_torch/cim/fused_kernel.py.
//
// What bounds it: bytes. Per packed column and plane it does ~20 integer
// operations on 8 bytes read, far below the H100's ops-per-byte balance, so
// the least time is (2 * n_bits + sum of output rows) * W * 4 bytes over
// the memory rate. The design serves that bound:
//   * one thread per 4 packed uint32 columns (128 words), looping over the
//     planes with carry_a, carry_s and the nz OR-tree in registers — the
//     sequential Pallas grid axis becomes this in-thread loop. The 4
//     columns travel as one 16-byte load or store: in the decode step this
//     cut the kernel's device time from 340 to 234 ms (PERF.md). A row
//     stride that is not a multiple of 4, or an unaligned view, takes the
//     same code with 1 column per thread;
//   * neighbouring threads read neighbouring columns of one plane row, so
//     every plane row is read once, coalesced, and each requested output row
//     is written once; the MSB plane is kept in registers for the (n+1)-th
//     module instead of being re-read;
//   * the op subset is a bitmask and the outputs a table of pointers:
//     unrequested outputs are neither computed nor written. The branches are
//     uniform across the grid, so they cost nothing here;
//   * the ragged edge is masked in the kernel (no padding of W to a block);
//   * gridDim.y walks a leading tile axis ([T, rows, W] stacks), so the
//     banked dispatcher launches all tiles of one access at once. gridDim.y
//     stops at 65535: the wrapper splits a longer tile axis over launches,
//     offsetting the pointers. A bank tile of 128 columns leaves 7/8 of a
//     256-thread block idle, yet the tiled access ran within 1.07x of the
//     same access untiled (PERF.md), so the block stays fixed.
// No shared memory, TMA or async copies yet: this version is right first.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kAdd = 0, kSub = 1, kLt = 2, kEq = 3, kGt = 4;
constexpr int kCarryAdd = 5, kCarrySub = 6, kBool0 = 7;
constexpr int kNumOps = 23;
constexpr uint32_t kBoolMask = 0xFFFFu << kBool0;
constexpr uint32_t kAddChain = (1u << kAdd) | (1u << kCarryAdd);
constexpr uint32_t kSubChain = (1u << kSub) | (1u << kLt) | (1u << kEq) |
                               (1u << kGt) | (1u << kCarrySub);

struct OutPtrs {
  uint32_t* p[kNumOps];
};

// the 16 two-input Boolean functions in minterm order (opset.BOOLEAN_OPS),
// composed from the single-access signal set {OR, AND, B, A}
__device__ __forceinline__ uint32_t boolean_plane(int k, uint32_t or_,
                                                  uint32_t and_, uint32_t b,
                                                  uint32_t a) {
  switch (k) {
    case 0: return 0u;                 // false
    case 1: return ~or_;               // nor
    case 2: return or_ & ~b;           // a_and_not_b
    case 3: return ~b;                 // not_b
    case 4: return or_ & ~a;           // not_a_and_b
    case 5: return ~a;                 // not_a
    case 6: return or_ & ~and_;        // xor
    case 7: return ~and_;              // nand
    case 8: return and_;               // and
    case 9: return ~(or_ & ~and_);     // xnor
    case 10: return a;                 // a
    case 11: return ~(or_ & ~a);       // a_or_not_b
    case 12: return b;                 // b
    case 13: return ~(or_ & ~b);       // not_a_or_b
    case 14: return or_;               // or
    default: return ~0u;               // true
  }
}

// V uint32 columns per thread: V = 4 gives 16-byte loads and stores when
// the row stride and every base pointer allow it, V = 1 otherwise.
template <int V>
struct alignas(4 * V) Lanes {
  uint32_t x[V];
};

template <int V>
__device__ __forceinline__ Lanes<V> load(const uint32_t* p) {
  return *reinterpret_cast<const Lanes<V>*>(p);
}

template <int V>
__device__ __forceinline__ void store(uint32_t* p, const Lanes<V>& v) {
  *reinterpret_cast<Lanes<V>*>(p) = v;
}

template <int V>
__global__ void fused_planes_kernel(const uint32_t* __restrict__ a,
                                    const uint32_t* __restrict__ b,
                                    int n_bits, long long w, uint32_t mask,
                                    OutPtrs out) {
  const long long col =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (col >= w) return;                              // ragged edge
  const long long tile = blockIdx.y;
  const long long n = n_bits;
  const uint32_t* at = a + tile * n * w + col;
  const uint32_t* bt = b + tile * n * w + col;
  // per-tile offsets of each output stack (arith n+1 rows, pred 1, bool n)
  const long long arith_off = tile * (n + 1) * w + col;
  const long long pred_off = tile * w + col;
  const long long bool_off = tile * n * w + col;
  const bool need_add = mask & kAddChain;
  const bool need_sub = mask & kSubChain;

  Lanes<V> carry_a, carry_s, nz, av, bv, o;
#pragma unroll
  for (int j = 0; j < V; ++j) {                      // C_IN: 0 add, 1 sub
    carry_a.x[j] = 0u;
    carry_s.x[j] = ~0u;
    nz.x[j] = 0u;
  }
  for (int i = 0; i < n_bits; ++i) {
    av = load<V>(at + i * w);
    bv = load<V>(bt + i * w);
    if (mask & kBoolMask) {
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (mask & (1u << (kBool0 + k))) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const uint32_t or_ = av.x[j] | bv.x[j], and_ = av.x[j] & bv.x[j];
            const uint32_t a_rec = ~(~and_ & (bv.x[j] | ~or_));   // OAI21
            o.x[j] = boolean_plane(k, or_, and_, bv.x[j], a_rec);
          }
          store<V>(out.p[kBool0 + k] + bool_off + i * w, o);
        }
      }
    }
    if (need_add) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const uint32_t or_ = av.x[j] | bv.x[j], and_ = av.x[j] & bv.x[j];
        const uint32_t x = or_ & ~and_;              // half-sum (addition)
        o.x[j] = x ^ carry_a.x[j];
        carry_a.x[j] = and_ | (carry_a.x[j] & x);    // generate | propagate
      }
      if (mask & (1u << kAdd)) store<V>(out.p[kAdd] + arith_off + i * w, o);
    }
    if (need_sub) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const uint32_t or_ = av.x[j] | bv.x[j], and_ = av.x[j] & bv.x[j];
        const uint32_t xn = ~(or_ & ~and_);          // half-sum, B inverted
        o.x[j] = xn ^ carry_s.x[j];
        carry_s.x[j] = (or_ & ~bv.x[j]) | (carry_s.x[j] & xn);
        nz.x[j] |= o.x[j];                           // OR tree, zero detect
      }
      if (mask & (1u << kSub)) store<V>(out.p[kSub] + arith_off + i * w, o);
    }
  }

  // (n+1)-th compute module: sign-extended inputs (av/bv hold the MSB plane)
  if (need_add) {
    Lanes<V> c;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const uint32_t x = av.x[j] ^ bv.x[j];
      o.x[j] = x ^ carry_a.x[j];
      c.x[j] = (av.x[j] & bv.x[j]) | (carry_a.x[j] & x);
    }
    if (mask & (1u << kAdd)) store<V>(out.p[kAdd] + arith_off + n * w, o);
    if (mask & (1u << kCarryAdd)) store<V>(out.p[kCarryAdd] + pred_off, c);
  }
  if (need_sub) {
    Lanes<V> c, lt, eq, gt;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const uint32_t nb = ~bv.x[j];
      const uint32_t xn = av.x[j] ^ nb;
      const uint32_t s_ext = xn ^ carry_s.x[j];
      const uint32_t z = nz.x[j] | s_ext;
      o.x[j] = s_ext;
      c.x[j] = (av.x[j] & nb) | (carry_s.x[j] & xn);
      lt.x[j] = s_ext;                               // sign of A - B
      eq.x[j] = ~z;                                  // AND tree over ~SUM
      gt.x[j] = ~s_ext & z;                          // not lt, not eq
    }
    if (mask & (1u << kSub)) store<V>(out.p[kSub] + arith_off + n * w, o);
    if (mask & (1u << kCarrySub)) store<V>(out.p[kCarrySub] + pred_off, c);
    if (mask & (1u << kLt)) store<V>(out.p[kLt] + pred_off, lt);
    if (mask & (1u << kEq)) store<V>(out.p[kEq] + pred_off, eq);
    if (mask & (1u << kGt)) store<V>(out.p[kGt] + pred_off, gt);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() as an int (0 = launched),
// or cudaErrorInvalidValue for a tile count outside [1, 65535].
// a, b: [n_tiles, n_bits, w] uint32 stacks; outs: kNumOps pointers indexed
// as opset.ALL_OPS, null where not requested.
extern "C" int fused_planes_launch(const void* a, const void* b, int n_bits,
                                   long long w, int n_tiles, unsigned mask,
                                   void* const* outs, void* stream) {
  if (n_tiles < 1 || n_tiles > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  OutPtrs o;
  bool vec = (w % 4 == 0) && aligned16(a) && aligned16(b);
  for (int i = 0; i < kNumOps; ++i) {
    o.p[i] = static_cast<uint32_t*>(outs[i]);
    if (o.p[i] != nullptr && !aligned16(o.p[i])) vec = false;
  }
  const int threads = 256;
  const long long per_thread = vec ? 4 : 1;
  const long long cols = (w + per_thread - 1) / per_thread;
  const dim3 grid(static_cast<unsigned>((cols + threads - 1) / threads),
                  static_cast<unsigned>(n_tiles));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  if (vec) {
    fused_planes_kernel<4><<<grid, threads, 0, s>>>(pa, pb, n_bits, w, mask, o);
  } else {
    fused_planes_kernel<1><<<grid, threads, 0, s>>>(pa, pb, n_bits, w, mask, o);
  }
  return static_cast<int>(cudaGetLastError());
}
