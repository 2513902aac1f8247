// Flash attention forward in bfloat16 for Hopper (sm_90a): TMA and wgmma.
//
//   q [B, Tq, Hq, D], k and v [B, Tk, Hkv, D], all bfloat16, contiguous,
//   16-byte aligned, D a multiple of 8 and at most 256,
//
// returning o [B, Tq, Hq, D] in bfloat16 and lse [B, Hq, Tq] in float32:
//
//   s   = scale * (q k^T)             (bf16 products, float32 sums)
//   s   = -1e30 where masked: causal keys past q_pos + (Tk - Tq)
//   o   = softmax(s) v,  lse = m + log(l)     (online: m, l, acc float32)
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (pallas_call at line 111) for the bfloat16 inputs that
// `repro_torch.kernels.flash_attention.route` sends here; float32 and any
// other bfloat16 call stay on csrc/flash_attention.cu (SIMT). The function
// is that kernel's, with one extra rounding: p is rounded to bfloat16 for
// the P V product (the reference keeps p in float32), about 2^-9 relative
// per weight, inside the bfloat16 tolerance of 2e-2. l sums the float32 p.
// Held against repro_torch/kernels/ref.py::mha_ref, o and lse.
//
// What bounds it: operations. At gemma-2b's train shape (1, 2048, 2048, 8
// query heads over 1 kv head, D = 256, causal) the two products are about
// 17.2 GFLOP of bf16 tensor-core work (0.0174 ms at 989 TFLOP/s) against
// about 19 MB moved (0.0057 ms at 3.35 TB/s).
//
// Design. The Pallas kernel walks a (B, Hq, q-blocks, k-blocks) grid whose
// last axis is sequential. Here one block owns one (batch row, q head,
// 64-row q tile), q tiles dispatched heaviest first (blockIdx.y counts from
// the last). Under the causal mask a q tile walks 1 to Tk/64 k tiles, and
// the heaviest tile's walk, a serial chain of tiles, bounds the launch; so
// the block holds two warpgroups that split the tile's k tiles in halves,
// each with its own K and V slot, and merges their (m, l, O) through shared
// memory at the end, as the online softmax folds one more tile (167 KB of
// shared memory at D = 256, one block per SM; one warpgroup walking every
// tile, 99 KB and two blocks per SM, was slower on the card). Tiles live in shared memory in bfloat16, loaded by TMA with
// 128-byte swizzle: each 64-row tile is D/64 boxes of 64 rows x 64 columns
// (128 bytes a row), the layout wgmma's shared-memory descriptors read. D
// below 64, 128 or 256 is padded with zeros by the box's out-of-bounds
// fill, and so are rows past Tq or Tk. Q is loaded once; each warpgroup's
// K and V slot has its own mbarrier and is refilled by the warpgroup's
// first thread as soon as its four warps are done with it, so the next K
// tile loads during the softmax and P V, the next V tile during the next
// S. Per k tile:
//   S = Q K^T: wgmma m64n64k16, both operands K-major from shared memory,
//      D/16 k-steps into a float32 accumulator (32 registers a thread);
//   the scale is applied to S in float32, then the mask; row max by
//      shuffles within each quad of the accumulator layout; m and l in
//      float32 (l as per-thread partial sums, reduced at the end);
//   P = exp(S - m) in bfloat16 registers: the m64n64 accumulator fragment
//      is, pair for pair, the A fragment of four k16 slices;
//   O = alpha O + P V: wgmma m64nDk16 with A from registers and V as an
//      MN-major (transposed) B from its swizzled tile; O is a 64 x D
//      float32 accumulator, 128 registers a thread at D = 256.
// Epilogue: o = acc / safe_l rounded to bfloat16, lse = m + log(safe_l).
//
// Masking, as the SIMT kernel and the reference: keys at or past Tk are
// never counted (p = 0); causal-masked keys get s = -1e30, so a row that
// sees no key (Tq > Tk) averages v over all Tk keys as mha_ref does; k
// tiles wholly past a q tile's last visible key are skipped unless the q
// tile holds such a row. Only tiles that cross the diagonal or Tk compare
// positions.
//
// TMA descriptors are encoded on the host for each call (4-D maps over
// [B, T, H, D], box 64 x 1 x 64 x 1), with cuTensorMapEncodeTiled taken
// through cudaGetDriverEntryPoint so the library needs no -lcuda, and
// passed as __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                  // q rows per block
constexpr int BK = 64;                  // keys per tile
constexpr int THREADS = 128;            // one warpgroup
constexpr int WGS = 2;                  // warpgroups per block
constexpr int BOX_BYTES = 64 * 128;     // 64 rows x 64 bf16 columns
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Launcher errors besides CUDA's (which are below 1000).
constexpr int ERR_ENTRY_POINT = 1001;   // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 1002;        // a tensor map was refused

// Shared memory: the Q tile, then each warpgroup's K and V slot, then the
// second warpgroup's m and l for the merge, then the barriers (Q's, then
// each warpgroup's K and V). Tiles are 1024-byte aligned, as the swizzle
// atoms must be; the merge writes the second warpgroup's O accumulator
// over its own K and V slots (128 threads x DP/2 floats = 2 TILE bytes).
template <int NC>
struct Layout {
  static constexpr int TILE = NC * BOX_BYTES;
  static constexpr int ML = (1 + 2 * WGS) * TILE;        // m, l of WG 1
  static constexpr int BARS = ML + THREADS * 4 * 4;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * WGS) + 1024;  // + align
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Waits for the barrier's phase `phase` to complete. A copy that never
// completes traps after about 2^32 cycles (seconds) instead of hanging the
// card; the launch then reports an error.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(phase) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 32)) __trap();
  }
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// K-major (Q, K): 8-row groups 1024 bytes apart; the leading offset is
// unused by swizzled K-major layouts. A k16 step inside a 128-byte row
// advances the start address by 32 bytes.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return smem_desc(addr, 16, 1024);
}
// MN-major (V as B of P V): 64-column blocks (one box, 64 rows x 128
// bytes) BOX_BYTES apart, 8-key groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return smem_desc(addr, BOX_BYTES, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// S[64 x 64] (+)= A[64 x 16] B[16 x 64]^T, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_m64n64(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n256(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_m64n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_m64n128(d, a, db);
  else wgmma_rs_m64n256(d, a, db);
}

// Named barrier 1 or 2 over the 128 threads of warpgroup 0 or 1 (ids as
// immediates, so the kernel holds three barriers, not all sixteen).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  if (wg == 0) asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

template <int NC>
__global__ void __launch_bounds__(THREADS * WGS, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int tq, int tk, int hq,
                            int hkv, int d, float scale, int causal) {
  using L = Layout<NC>;
  constexpr int DP = 64 * NC;             // padded head width
  constexpr int TILE = L::TILE;           // one 64-row tile
  constexpr int NACC = DP / 2;            // O accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);   // generic address
  const int wg = threadIdx.x / THREADS;   // warpgroup
  const int tid = threadIdx.x % THREADS;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + TILE + wg * 2 * TILE;   // this warpgroup's slots
  const uint32_t sV = sK + TILE;
  const uint32_t bar_q = base + L::BARS;
  const uint32_t bar_k = bar_q + 8 * (1 + 2 * wg);
  const uint32_t bar_v = bar_k + 8;

  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  // causal: row r sees keys <= r + shift (q aligned to the END of the kv
  // span); tiles past the q tile's last visible key are skipped unless
  // its first row sees no key at all
  const int shift = tk - tq;
  int k_end = tk;
  if (causal && q0 + shift >= 0)
    k_end = min(tk, min(q0 + BQ, tq) - 1 + shift + 1);
  const int nk = (k_end + BK - 1) / BK;
  // this warpgroup's k tiles: the first half to warpgroup 0, the rest to 1
  const int half = (nk + 1) / 2;
  const int j0 = wg == 0 ? 0 : half;
  const int j1 = wg == 0 ? half : nk;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + 2 * WGS; ++i) mbar_init(bar_q + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    if (wg == 0) {
      mbar_expect_tx(bar_q, TILE);
      for (int c = 0; c < NC; ++c)
        tma_load(sQ + c * BOX_BYTES, &tm_q, bar_q, 64 * c, h, q0, b);
    }
    if (j0 < j1) {
      mbar_expect_tx(bar_k, TILE);
      for (int c = 0; c < NC; ++c)
        tma_load(sK + c * BOX_BYTES, &tm_k, bar_k, 64 * c, hk, j0 * BK, b);
      mbar_expect_tx(bar_v, TILE);
      for (int c = 0; c < NC; ++c)
        tma_load(sV + c * BOX_BYTES, &tm_v, bar_v, 64 * c, hk, j0 * BK, b);
    }
  }

  // Accumulator layout (wgmma m64nN, f32): element i of a thread is at row
  // 16 warp + lane/4 + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 (lane & 3)
  // + (i & 1). So a thread holds two rows, r_lo and r_lo + 8.
  const int r_lo = q0 + 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.0f, 0.0f};

  if (j0 < j1) mbar_wait(bar_q, 0);
  for (int j = j0; j < j1; ++j) {
    const uint32_t phase = (j - j0) & 1;
    const int k0 = j * BK;

    // S = Q K^T
    mbar_wait(bar_k, phase);
    fence_regs<32>(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NC; ++kk) {
      const uint32_t off = (kk >> 2) * BOX_BYTES + (kk & 3) * 32;
      wgmma_ss_m64n64(sc, desc_k_major(sQ + off), desc_k_major(sK + off),
                      kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(sc);
    warpgroup_sync(wg);       // every warp is done reading the K slot
    if (tid == 0 && j + 1 < j1) {
      mbar_expect_tx(bar_k, TILE);
      for (int c = 0; c < NC; ++c)
        tma_load(sK + c * BOX_BYTES, &tm_k, bar_k, 64 * c, hk, k0 + BK, b);
    }

    // scale, mask, online softmax in the accumulator's layout
    const bool edge = (causal && k0 + BK - 1 > q0 + shift) || k0 + BK > tk;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = sc[i] * scale;
      if (edge) {
        const int col = k0 + 8 * (i >> 2) + cq + (i & 1);
        const int row = r_lo + 8 * ((i >> 1) & 1);
        if (col >= tk || (causal && col > row + shift)) x = NEG_INF;
      }
      sc[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = exp2f((m_r[r] - m_new) * LOG2E);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
    // P in bfloat16: pa[4 kk .. 4 kk + 3] is the A fragment of keys
    // 16 kk .. 16 kk + 15 (rows lo, hi at columns c, then at c + 8)
    uint32_t pa[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      float p0 = exp2f((sc[i] - m_r[r]) * LOG2E);
      float p1 = exp2f((sc[i + 1] - m_r[r]) * LOG2E);
      if (edge) {
        const int col = k0 + 8 * (i >> 2) + cq;
        if (col >= tk) p0 = 0.0f;
        if (col + 1 >= tk) p1 = 0.0f;
      }
      l_r[r] += p0 + p1;
      pa[i >> 1] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V
    mbar_wait(bar_v, phase);
    fence_regs<NACC>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<DP>(acc, pa + 4 * kk, desc_mn_major(sV + kk * 2048));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<NACC>(acc);
    warpgroup_sync(wg);       // every warp is done reading the V slot
    if (tid == 0 && j + 1 < j1) {
      mbar_expect_tx(bar_v, TILE);
      for (int c = 0; c < NC; ++c)
        tma_load(sV + c * BOX_BYTES, &tm_v, bar_v, 64 * c, hk, k0 + BK, b);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  {
    // merge: warpgroup 1 leaves (m, l, acc) of the later keys over its own
    // slots, which no copy or product touches any more; warpgroup 0 folds
    // them into its own, as the online softmax folds one more tile
    float* const acc1 = reinterpret_cast<float*>(gbase + TILE + 2 * TILE);
    float* const ml1 = reinterpret_cast<float*>(gbase + L::ML);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc1[i * THREADS + tid] = acc[i];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ml1[r * THREADS + tid] = m_r[r];
        ml1[(2 + r) * THREADS + tid] = l_r[r];
      }
    }
    __syncthreads();
    if (wg == 1) return;
    float a0[2], a1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = ml1[r * THREADS + tid];
      const float m_new = fmaxf(m_r[r], m1);
      a0[r] = exp2f((m_r[r] - m_new) * LOG2E);
      a1[r] = exp2f((m1 - m_new) * LOG2E);
      l_r[r] = a0[r] * l_r[r] + a1[r] * ml1[(2 + r) * THREADS + tid];
      m_r[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i)
      acc[i] = a0[(i >> 1) & 1] * acc[i] +
               a1[(i >> 1) & 1] * acc1[i * THREADS + tid];
  }

  const long long q_stride = (long long)hq * d;      // between tokens
  __nv_bfloat16* ob = o + (long long)b * tq * q_stride + (long long)h * d;
  float safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    safe[r] = l_r[r] == 0.0f ? 1.0f : l_r[r];
    const int row = r_lo + 8 * r;
    if ((lane & 3) == 0 && row < tq)
      lse[((long long)b * hq + h) * tq + row] = m_r[r] + logf(safe[r]);
  }
#pragma unroll
  for (int jn = 0; jn < DP / 8; ++jn) {
    const int col = 8 * jn + cq;
    if (col >= d) continue;           // d is even: col + 1 < d too
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r_lo + 8 * r;
      if (row >= tq) continue;
      *reinterpret_cast<uint32_t*>(ob + row * q_stride + col) =
          pack_bf16(acc[4 * jn + 2 * r] / safe[r],
                    acc[4 * jn + 2 * r + 1] / safe[r]);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [B, T, H, D] bfloat16, contiguous: dims innermost first, box 64 columns
// x 1 head x 64 tokens x 1 batch row, 128-byte swizzle, zeros out of bounds.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int b, int t,
            int h, int d) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)t,
                              (cuuint64_t)b};
  const cuuint64_t row = 2ull * d;
  const cuuint64_t strides[3] = {row, row * h, row * h * t};
  const cuuint32_t box[4] = {64, 1, BK, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NC>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int tq, int tk, int hq, int hkv, int d, float scale,
           int causal, cudaStream_t stream) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_ENTRY_POINT;
  CUtensorMap mq, mk, mv;
  if (!encode(fn, &mq, q, b, tq, hq, d) || !encode(fn, &mk, k, b, tk, hkv, d) ||
      !encode(fn, &mv, v, b, tk, hkv, d))
    return ERR_ENCODE;
  constexpr int bytes = Layout<NC>::BYTES;
  auto kernel = flash_attention_sm90_kernel<NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(hq, (tq + BQ - 1) / BQ, b);
  kernel<<<grid, THREADS * WGS, bytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      tq, tk, hq, hkv, d, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// bfloat16 q, k, v and o. Returns the CUDA error of the attribute call or
// the launch (0 on success), or 1001 / 1002 when the tensor-map encoder is
// missing or refuses a map. The wrapper checks what the kernel takes
// (route() == "sm90") before calling.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int b, int tq, int tk, int hq,
                                           int hkv, int d, float scale,
                                           int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch<1>(q, k, v, o, lse, b, tq, tk, hq, hkv, d, scale, causal, s);
  if (d <= 128)
    return launch<2>(q, k, v, o, lse, b, tq, tk, hq, hkv, d, scale, causal, s);
  return launch<4>(q, k, v, o, lse, b, tq, tk, hq, hkv, d, scale, causal, s);
}
