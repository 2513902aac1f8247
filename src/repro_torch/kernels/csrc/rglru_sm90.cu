// RG-LRU recurrence (Griffin / RecurrentGemma) for Hopper (sm_90a): channel
// tiles streamed through shared memory by TMA.
//
//   a_t = exp(-c * softplus(log_lambda) * sigmoid(r_t))
//   h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) * sigmoid(i_t) * x_t
//
// over x, r, i [B, T, D] in float32 or bfloat16, returning y = h in the
// input dtype and h_T in float32, from h0 [B, D] (float32) or zeros.
//
// Replaces the TPU kernel src/repro/kernels/rglru.py::_rglru_kernel
// (pallas_call at line 79) for the calls `repro_torch.kernels.rglru.route`
// sends here (prefill: T of at least SM90_MIN_T); decode stays on
// csrc/rglru.cu, one thread per channel. Held against repro_torch/kernels/
// ref.py::rglru_ref (atol 1e-5 in float32; in bfloat16, h_T at 1e-5 and y
// within one bf16 rounding) and equal to the bit to csrc/rglru.cu's kernel
// on the same inputs.
//
// What bounds it: bytes, with the special-function unit close behind. Per
// element it reads x, r, i and writes y (4 * itemsize bytes: 0.0200 ms at
// (1, 2048, 4096) bf16 over 3.35 TB/s) and computes three exponentials,
// two reciprocals and a square root (about 6 special-function operations:
// 0.012 ms there at 16 a clock per SM on 132 SMs) among about 16 float
// operations. Only h = a h + m g depends on the previous step: one rounded
// product and one add, about 8 cycles, 0.009 ms for 2048 steps. So the
// gate math must overlap the loads and the chain; none of the three may
// wait on another. Measured on one H100 (700 W), it does at the chain and
// the loads but not at the gates: at (1, 2048, 4096) bf16 it takes about
// 2.4x the byte bound, and a build without the gate math runs as fast as
// the TMA ring alone, so the gate warps' instruction rate sets the pace.
//
// Design. The rows kernel (csrc/rglru.cu) gives each (b, d) channel one
// thread that loads, computes the gates and walks the chain in one
// dependent loop; at B * D = 4096 that is 16 blocks on 16 SMs. Here a
// block owns `channels` (C = 16 or 32) contiguous channels of one batch
// row, so B * ceil(D / C) blocks spread over every SM (128 at (1, T, 4096)
// with C = 32), and its warps split the work by sub-partition (warp w
// is scheduled on sub-partition w % 4):
//   warp 0, producer: one lane keeps a ring of `stages` time tiles in
//      flight, each [TILE_T x C] of x, r and i loaded by TMA (a 3-D map
//      over [B, T, D], box C x TILE_T x 1) completing on the stage's full
//      barrier; it refills a stage when the gate warps release it;
//   gate warps (all others but sub-partition 1's): turn each arrived tile,
//      in strips of 32 elements, into (a, m g) pairs, m g = sqrt(max(1 -
//      a^2, 1e-12)) * (sigmoid(i) * x), float32, in a double-buffered gate
//      tile, then release the input stage. The IEEE division and square
//      root each branch to a slow path that the compiler schedules nothing
//      across, so a thread stages BATCH elements through each step of the
//      formula and a block holds many gate warps; each lane keeps one
//      channel, so softplus(log_lambda) is computed once;
//   warp 1, scan: lane = channel; walks h = a h + m g down the gate tile
//      with h in a register, the next CHUNK pairs loaded while this
//      chunk's chain runs, writes y into a double-buffered output tile,
//      releases the gate tile and hands y to a TMA store. The other warps
//      of its sub-partition leave at once, so nothing competes with the
//      chain for scheduler slots.
// All hand-offs are mbarriers in shared memory, one arrival a warp after
// __syncwarp: nothing crosses blocks, so there is no grid barrier and no
// look-back. The ragged edges are TMA's: rows past T and channels past D
// load as zeros and are clipped from the stores; the scan walks only the
// tile's real steps, so h_T is the state after step T - 1. A wait that
// never ends traps after about 2^32 cycles instead of hanging the card.
// `repro_torch.kernels.rglru.tile_geometry` alone sizes the tile, ring,
// warps and grid; the launch checks it.
//
// Rounding: the same per-step order and the same functions as csrc/
// rglru.cu (softplus copied below, sigmoid written out as 1 / (1 +
// expf(-v)), the __fmul_rn / __fadd_rn / __fsub_rn products and sums that
// nvcc never fuses, expf, log1pf, sqrtf), so the two kernels agree to the
// bit. The only change is where m g is formed (a gate warp, ahead of the
// chain, several elements at once), not how.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GATE_STAGES = 2;          // gate tiles between gates and scan
constexpr int Y_STAGES = 2;             // output tiles in flight to memory
constexpr int ALIGN = 128;              // shared base alignment for TMA
constexpr int TILE_T = 64;              // time steps a tile
constexpr int CHUNK = 8;                // scan steps staged in registers
constexpr int BATCH = 4;                // elements a gate thread stages
constexpr int MAX_WARPS = 32;           // 1024 threads a block
constexpr int MAX_THREADS = 32 * MAX_WARPS;
constexpr int SMEM_MAX = 232448;        // a block's shared memory on the H100

// Launcher errors besides CUDA's (which are below 1000).
constexpr int ERR_ENTRY_POINT = 1001;   // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 1002;        // a tensor map was refused
constexpr int ERR_GEOMETRY = 1003;      // geometry or shape outside the rules

// The caller's geometry (repro_torch/kernels/rglru.py::Geometry).
struct Geometry {
  int channels;     // C: channels of one batch row per block
  int stages;       // input ring depth
  int warps;        // warps a block (4 to 32, a multiple of 4)
  int blocks;       // B * ceil(D / C)
  int smem;         // dynamic shared bytes, alignment slack included
};

// Shared memory, in order: the input ring (stage s: x, r, i tiles), the
// gate ring (stage k: a, then m g, float32), the output ring, then the
// barriers (full and empty per input stage, full and empty per gate
// stage). An input or output tile is TILE_T * C * itemsize bytes, a
// multiple of 128 (C is 16 or 32); a gate tile holds (a, m g) pairs,
// interleaved.
__host__ __device__ inline int in_ring_bytes(const Geometry& g, int isz) {
  return g.stages * 3 * TILE_T * g.channels * isz;
}
__host__ __device__ inline int gate_ring_bytes(const Geometry& g) {
  return GATE_STAGES * TILE_T * g.channels * 8;
}
__host__ __device__ inline int smem_bytes(const Geometry& g, int isz) {
  return in_ring_bytes(g, isz) + gate_ring_bytes(g) +
         Y_STAGES * TILE_T * g.channels * isz +
         8 * (2 * g.stages + 2 * GATE_STAGES) + ALIGN;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Waits for the barrier's phase of parity `phase` to complete; traps after
// about 2^32 cycles (seconds) instead of hanging the card.
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

// One box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// One box from shared memory to a 3-D tensor map (clipped at its bounds).
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most Y_STAGES - 1 stores still read their shared tile.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n"
               :: "n"(Y_STAGES - 1) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as a torch cast
}

// As csrc/rglru.cu: jax.nn.softplus is logaddexp(v, 0), no threshold.
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
}

// Warp roles by sub-partition (a block's warp w is scheduled on sub-partition
// w % 4): warp 0 produces, warp 1 scans, the other warps of sub-partition
// 1 leave at once so the scan warp runs alone there, and every other
// warp computes gates. gate_warps() counts them; gate_rank() numbers them.
__host__ __device__ inline int gate_warps(int warps) {
  return (warps - 2) - (warps - 2) / 4;
}
__device__ __forceinline__ int gate_rank(int warp) {
  return (warp - 2) - (warp - 2) / 4;
}

template <typename T, int CH>
__global__ void __launch_bounds__(MAX_THREADS)
rglru_tile_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_r,
                  const __grid_constant__ CUtensorMap tm_i,
                  const __grid_constant__ CUtensorMap tm_y,
                  const float* __restrict__ log_lambda,
                  const float* __restrict__ h0, float* __restrict__ h_out,
                  int t_len, int d, float c, Geometry geo) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~uint32_t(ALIGN - 1);
  uint8_t* const smem = smem_raw + (base - raw);   // generic address
  constexpr int ELEMS = TILE_T * CH;               // one tile's elements
  constexpr int IN_BYTES = ELEMS * static_cast<int>(sizeof(T));
  const int stages = geo.stages;
  const int blocks_d = (d + CH - 1) / CH;
  const int b = blockIdx.x / blocks_d;
  const int d0 = (blockIdx.x % blocks_d) * CH;
  const int n_tiles = (t_len + TILE_T - 1) / TILE_T;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_gate = gate_warps(geo.warps);

  uint8_t* const in_ring = smem;
  float2* const gate_ring =
      reinterpret_cast<float2*>(smem + in_ring_bytes(geo, sizeof(T)));
  T* const y_ring = reinterpret_cast<T*>(
      smem + in_ring_bytes(geo, sizeof(T)) + gate_ring_bytes(geo));
  const uint32_t bars = base + in_ring_bytes(geo, sizeof(T)) +
                        gate_ring_bytes(geo) + Y_STAGES * IN_BYTES;
  auto in_full = [&](int s) { return bars + 8 * s; };
  auto in_empty = [&](int s) { return bars + 8 * (stages + s); };
  auto gate_full = [&](int k) { return bars + 8 * (2 * stages + k); };
  auto gate_empty = [&](int k) {
    return bars + 8 * (2 * stages + GATE_STAGES + k);
  };

  // Each warp's first lane arrives for the warp, after __syncwarp has
  // ordered the other lanes' shared-memory reads and writes before it.
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(in_full(s), 1);
      mbar_init(in_empty(s), n_gate);
    }
    for (int k = 0; k < GATE_STAGES; ++k) {
      mbar_init(gate_full(k), n_gate);
      mbar_init(gate_empty(k), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // producer: tile k into stage k % stages, once the gates released the
    // stage's previous tile (k - stages)
    if (lane == 0) {
      for (int k = 0; k < n_tiles; ++k) {
        const int s = k % stages;
        if (k >= stages) mbar_wait(in_empty(s), (k / stages - 1) & 1);
        mbar_expect_tx(in_full(s), 3 * IN_BYTES);
        const uint32_t dst = smem_u32(in_ring + s * 3 * IN_BYTES);
        tma_load(dst, &tm_x, in_full(s), d0, k * TILE_T, b);
        tma_load(dst + IN_BYTES, &tm_r, in_full(s), d0, k * TILE_T, b);
        tma_load(dst + 2 * IN_BYTES, &tm_i, in_full(s), d0, k * TILE_T, b);
      }
    }
  } else if (warp == 1) {
    // scan: lane = channel d0 + lane
    const bool live = lane < CH && d0 + lane < d;
    const long long row = static_cast<long long>(b) * d + d0 + lane;
    float h = (live && h0 != nullptr) ? h0[row] : 0.0f;
    for (int k = 0; k < n_tiles; ++k) {
      const int gs = k % GATE_STAGES;
      const int ys = k % Y_STAGES;
      const int steps = min(TILE_T, t_len - k * TILE_T);
      if (k >= Y_STAGES) {          // the store of tile k - Y_STAGES read
        if (lane == 0) bulk_wait_read();
        __syncwarp();
      }
      mbar_wait(gate_full(gs), (k / GATE_STAGES) & 1);
      if (lane < CH) {
        const float2* am = gate_ring + gs * ELEMS + lane;
        T* yv = y_ring + ys * ELEMS + lane;
        if (steps == TILE_T) {
          // a whole tile, unrolled: (a, m g) come through registers CHUNK
          // steps at a time, each chunk loaded while the one before it
          // walks its chain (a load after a store of y that may alias it
          // cannot be hoisted, so loading step by step would put shared
          // memory's latency on every step); every offset is a constant
          float2 buf[2][CHUNK];
#pragma unroll
          for (int u = 0; u < CHUNK; ++u) buf[0][u] = am[u * CH];
#pragma unroll
          for (int q = 0; q < TILE_T / CHUNK; ++q) {
            if (q + 1 < TILE_T / CHUNK) {
#pragma unroll
              for (int u = 0; u < CHUNK; ++u)
                buf[(q + 1) & 1][u] = am[((q + 1) * CHUNK + u) * CH];
            }
#pragma unroll
            for (int u = 0; u < CHUNK; ++u) {
              h = __fadd_rn(__fmul_rn(buf[q & 1][u].x, h), buf[q & 1][u].y);
              store(yv + (q * CHUNK + u) * CH, h);
            }
          }
        } else {                      // the last steps of a ragged T
          for (int j = 0; j < steps; ++j) {
            const float2 p = am[j * CH];
            h = __fadd_rn(__fmul_rn(p.x, h), p.y);
            store(yv + j * CH, h);
          }
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(gate_empty(gs));
        tma_store(&tm_y, smem_u32(y_ring + ys * ELEMS), d0, k * TILE_T, b);
        bulk_commit();
      }
    }
    if (lane == 0) bulk_wait_all();
    if (live) h_out[row] = h;
  } else if (warp % 4 != 1) {
    // gates. A tile is ELEMS / 32 strips of 32 elements (32 / C rows each;
    // element e is t = e / C, c = e % C); gate warp `rank` takes strips
    // rank, rank + n_gate, ... BATCH at a time, so each lane keeps channel
    // lane % C (32 % C == 0). Whole tiles: rows past T arrive as TMA's
    // zeros and their gates are never read by the scan
    const int rank = gate_rank(warp);
    const int cc = lane % CH;
    const float neg_c_decay =
        d0 + cc < d ? __fmul_rn(-c, softplus(log_lambda[d0 + cc])) : 0.0f;
    constexpr int strips = ELEMS / 32;
    for (int k = 0; k < n_tiles; ++k) {
      const int s = k % stages;
      const int gs = k % GATE_STAGES;
      mbar_wait(in_full(s), (k / stages) & 1);
      if (k >= GATE_STAGES)
        mbar_wait(gate_empty(gs), (k / GATE_STAGES - 1) & 1);
      const T* xs = reinterpret_cast<const T*>(in_ring + s * 3 * IN_BYTES);
      const T* rs = xs + ELEMS;
      const T* is = rs + ELEMS;
      float2* am = gate_ring + gs * ELEMS;
      // BATCH strips at a time, stage by stage: the division and the
      // square root branch to a slow path that the compiler does not move
      // code across, so computing one element after another would put
      // each element's whole dependent latency in series
      for (int s0 = rank; s0 < strips; s0 += BATCH * n_gate) {
        float sr[BATCH], si[BATCH], xv[BATCH], a[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {   // past the last strip: repeat it
          const int e = min(s0 + u * n_gate, strips - 1) * 32 + lane;
          sr[u] = load_f32(rs + e);
          si[u] = load_f32(is + e);
          xv[u] = load_f32(xs + e);
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          sr[u] = 1.0f + expf(-sr[u]);
          si[u] = 1.0f + expf(-si[u]);
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {   // sigmoid(r), sigmoid(i)
          sr[u] = 1.0f / sr[u];
          si[u] = 1.0f / si[u];
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          a[u] = expf(__fmul_rn(neg_c_decay, sr[u]));
          xv[u] = __fmul_rn(si[u], xv[u]);   // gated
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const float mult =
              sqrtf(fmaxf(__fsub_rn(1.0f, __fmul_rn(a[u], a[u])), 1e-12f));
          if (s0 + u * n_gate < strips)
            am[(s0 + u * n_gate) * 32 + lane] =
                make_float2(a[u], __fmul_rn(mult, xv[u]));
        }
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(in_empty(s));
        mbar_arrive(gate_full(gs));
      }
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

// [B, T, D] contiguous: dims innermost first, box C channels x TILE_T steps
// x 1 batch row, no swizzle, zeros out of bounds.
template <typename T>
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int b,
            long long t, int d, const Geometry& g) {
  const CUtensorMapDataType type = sizeof(T) == 4
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)b};
  const cuuint64_t row = (cuuint64_t)d * sizeof(T);
  const cuuint64_t strides[2] = {row, row * (cuuint64_t)t};
  const cuuint32_t box[3] = {(cuuint32_t)g.channels, (cuuint32_t)TILE_T, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const void* x, const void* r, const void* i, const float* ll,
           const float* h0, void* y, float* h_out, int batch,
           long long t_len, int d, float c, const Geometry& g,
           cudaStream_t s) {
  const int isz = static_cast<int>(sizeof(T));
  const long long blocks_d = (d + (long long)g.channels - 1) / g.channels;
  if ((g.channels != 16 && g.channels != 32) || g.stages < 1 ||
      g.stages > 8 || g.warps < 4 || g.warps > MAX_WARPS ||
      g.warps % 4 || g.blocks != batch * blocks_d ||
      g.smem != smem_bytes(g, isz) ||
      g.smem > SMEM_MAX || batch < 1 || t_len < 1 || t_len > 0x7fffffffLL ||
      d < 1 || ((long long)d * isz) % 16 || !aligned(x) || !aligned(r) ||
      !aligned(i) || !aligned(y))
    return ERR_GEOMETRY;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_ENTRY_POINT;
  CUtensorMap mx, mr, mi, my;
  if (!encode<T>(fn, &mx, x, batch, t_len, d, g) ||
      !encode<T>(fn, &mr, r, batch, t_len, d, g) ||
      !encode<T>(fn, &mi, i, batch, t_len, d, g) ||
      !encode<T>(fn, &my, y, batch, t_len, d, g))
    return ERR_ENCODE;
  auto kernel = g.channels == 32 ? rglru_tile_kernel<T, 32>
                                  : rglru_tile_kernel<T, 16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<g.blocks, 32 * g.warps, g.smem, s>>>(
      mx, mr, mi, my, ll, h0, h_out, static_cast<int>(t_len), d, c, g);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`. x, r, i, y: contiguous [batch, t_len, d] of float
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1), 16-byte aligned, d * itemsize a
// multiple of 16; log_lambda: float [d]; h0: float [batch, d] or null (zero
// state); h_out: float [batch, d]. The geometry is tile_geometry's.
// Returns the CUDA error of the attribute call or the launch (0 on
// success), 1001 / 1002 when the tensor-map encoder is missing or refuses a
// map, 1003 when the geometry or shape breaks the rules above.
extern "C" int rglru_sm90_launch(const void* x, const void* r, const void* i,
                                 const void* log_lambda, const void* h0,
                                 void* y, void* h_out, int batch,
                                 long long t_len, int d, int is_bf16, float c,
                                 int channels, int stages, int warps,
                                 int blocks, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry g{channels, stages, warps, blocks, smem};
  const float* ll = static_cast<const float*>(log_lambda);
  const float* h_in = static_cast<const float*>(h0);
  float* h_o = static_cast<float*>(h_out);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, r, i, ll, h_in, y, h_o, batch, t_len, d,
                                 c, g, s);
  return launch<float>(x, r, i, ll, h_in, y, h_o, batch, t_len, d, c, g, s);
}
