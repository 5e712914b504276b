// Fused SELU-MLP tower stack for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel graphinvent_tpu/models/fused_enn.py
// (`_kernel`, launched by `_call` through pl.pallas_call): for a tile of
// rows, every layer of E independent SELU MLPs over the same input, with
// the intermediates kept on chip and only the last layer written out.
// Dots take the compute dtype with f32 accumulation; the bias (pre-rounded
// to the compute dtype) and SELU run in f32; the result is rounded to the
// compute dtype between layers.
//
// What bounds it on the H100: at the GGNN widths the message stack is
// 18.5 GFLOP on ~12 MB per launch (13,000 rows, 100 -> 4x250 -> 100, E=3),
// far above the card's ~295 bf16 flop/byte ridge, so the data-sheet bound
// is the tensor cores.  The weights cannot stay on chip (the message stack
// is ~1.4 MB in bf16, f_add_2's MLP ~2.8 MB, a block has 227 KB), so each
// block streams every layer's weights from L2 once per row tile: the L2 to
// SM rate and the row tile's height set how close it gets to that bound.
//
// bf16 design (fused_enn_wgmma_kernel):
//  * Weights.  The wrapper lays each layer out once per model as the exact
//    shared-memory image wgmma's B operand reads: per tower and per K-slab
//    of 64, chunks of 64 output columns, each 64 x 64 bf16 K-major in the
//    128-byte swizzle (8 KB).  A block's slab (its chunks of one K-slab) is
//    contiguous, so one thread of a producer warp moves it with a single
//    1-D bulk copy (cp.async.bulk ... mbarrier::complete_tx) into a ring
//    of 2-8 stages; it runs ahead across layer boundaries, bounded only by
//    the ring's empty barriers.
//  * Activations.  Two ping-pong buffers of TM rows in the A operand's
//    K-major 128-byte-swizzled layout.  Consumer warpgroups (64 rows each)
//    run wgmma m64n64k16 on the slab that arrived, up to 4 chunks (256
//    columns, 128 f32 accumulators a thread) per pass over K.  The epilogue
//    adds the bias and applies SELU in f32 on the accumulators, rounds to
//    bf16 and writes the next buffer (or, for the last layer, the masked
//    output), then fences the generic proxy against the next wgmma.
//  * Clusters.  For few rows (the 1,000-row heads) C blocks (C <= 8) share
//    one 64-row tile: each computes 1/C of every layer's column chunks from
//    1/C of the weights and stores its bf16 slice into every peer's next
//    buffer through distributed shared memory, then arrives on each peer's
//    layer mbarrier.  A layer with fewer chunks than C runs on fewer blocks.
//  * Zero padding.  Padded weight rows and columns and padded biases are
//    0, SELU(0) = 0, and the input tile is zero-filled, so padded columns
//    stay 0 from layer to layer; only the final store is masked.
// The launch plan (TM = 64 or 128 rows, cluster size) comes from the
// wrapper (fused_enn.launch_plan); this file checks it and sizes the ring.
//
// f32 (the parity dtype) runs on the CUDA cores (fused_enn_f32_kernel).
//
// Plain C interface (loaded with ctypes): pointers and the stream come in
// as void*, errors go back as the cudaError_t code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kThreads = 256;      // f32 kernel
constexpr int kTileF32 = 32;       // rows per block, f32
constexpr int kChunk = 64;         // output columns per wgmma, K per slab
constexpr int kChunkBytes = kChunk * kChunk * 2;
constexpr int kMaxChunks = 4;      // chunks per pass (128 accumulators)
constexpr int kMaxStages = 8;
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 232448;
constexpr int kBarrierBytes = 8 * (2 * kMaxStages + 2);
// a pass's biases, per warpgroup, in bf16: they were rounded through it
constexpr int kBiasBytes = 2 * kMaxChunks * kChunk * 2;
constexpr float kSeluAlpha = 1.6732632423543772f;
constexpr float kSeluScale = 1.0507009873554805f;

struct Layout {
  int n_layers;
  int dims[kMaxLayers + 1];      // true widths: I, O_0, ..., O_{n-1}
  int pads[kMaxLayers + 1];      // the same, rounded up to 16
  int pad64[kMaxLayers + 1];     // the same, rounded up to 64 (bf16)
  long long w_off[kMaxLayers];   // element offset of layer l's weights
  long long b_off[kMaxLayers];   // element offset of layer l's (E, Op)
  int lda;                       // f32: shared-memory row stride, elements
  // bf16 wgmma kernel
  int cluster;                   // blocks sharing one row tile
  int stages, stage_bytes;       // weight ring
  int act_bytes[2];              // ping-pong activation buffers
};

__device__ __forceinline__ float selu(float v) {
  return kSeluScale * (v > 0.f ? v : kSeluAlpha * (expf(v) - 1.f));
}

// the same without a branch, with the hardware exponential (a few f32 ulps,
// far below one bf16 ulp; exact for v > 0): the bf16 epilogue's form
__device__ __forceinline__ float selu_fast(float v) {
  return kSeluScale * fmaxf(v, 0.f) +
         kSeluScale * kSeluAlpha * (__expf(fminf(v, 0.f)) - 1.f);
}

// ---------------------------------------------------------------- f32 ----

template <int TM>
__global__ void __launch_bounds__(kThreads)
fused_enn_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ out,
                     int R, Layout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* cur = reinterpret_cast<float*>(smem);
  float* nxt = cur + TM * L.lda;

  const int e = blockIdx.y;
  const int row0 = blockIdx.x * TM;

  const int I = L.dims[0], Ip = L.pads[0];
  for (int idx = threadIdx.x; idx < TM * Ip; idx += kThreads) {
    const int r = idx / Ip, c = idx - r * Ip;
    const int gr = row0 + r;
    cur[r * L.lda + c] = (gr < R && c < I) ? x[(long long)gr * I + c] : 0.f;
  }
  __syncthreads();

  for (int l = 0; l < L.n_layers; ++l) {
    const int K = L.dims[l], Kp = L.pads[l];
    const int O = L.dims[l + 1], Op = L.pads[l + 1];
    const float* wl = w + L.w_off[l] + (long long)e * Kp * Op;
    const float* bl = b + L.b_off[l] + (long long)e * Op;
    const bool last = l == L.n_layers - 1;
    for (int c = threadIdx.x; c < Op; c += kThreads) {
      float acc[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) acc[r] = 0.f;
      for (int k = 0; k < K; ++k) {
        const float wv = wl[(long long)k * Op + c];
#pragma unroll
        for (int r = 0; r < TM; ++r) acc[r] = fmaf(cur[r * L.lda + k], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float v = selu(acc[r] + bl[c]);
        if (!last) {
          nxt[r * L.lda + c] = v;
        } else if (row0 + r < R && c < O) {
          out[((long long)e * R + row0 + r) * O + c] = v;
        }
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

// ------------------------------------------------- PTX building blocks ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

// waits until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{ .reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{ .reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 "
        "p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// copies bytes of this block's shared memory into a peer's (dst and bar
// are shared::cluster addresses of that peer)
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, uint32_t src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ void fence_async_cta() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void warpgroup_bar(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row atoms
// 1,024 bytes apart (SBO), leading offset unused for this layout.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D (64 x 64, f32) += A (64 x 16) * B (16 x 64), both bf16 K-major in smem
__device__ __forceinline__ void wgmma_64x64(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{ .reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// byte offset of element (row, col) in a K-major 128-byte-swizzled buffer
// of `rows` rows: 64-column chunks of rows x 128 bytes, back to back
__device__ __forceinline__ uint32_t swz_offset(int row, int col, int rows) {
  const int kc = col >> 6, cc = col & 63;
  return (uint32_t)(kc * rows * 128 + row * 128 +
                    ((((cc >> 3) ^ (row & 7))) << 4) + ((cc & 7) << 1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------------- bf16 (wgmma) ----

// The slabs of one layer that block `rank` of a cluster of C loads and
// consumes, in order: passes of up to kMaxChunks column chunks, each pass a
// run over the layer's K-slabs.  Producer and consumers walk the same order.
struct LayerWork {
  int nk;        // K-slabs
  int nch;       // column chunks of the whole layer
  int c0, c1;    // this block's chunks [c0, c1)
};

__device__ __forceinline__ LayerWork layer_work(const Layout& L, int l,
                                                int rank) {
  LayerWork w;
  w.nk = L.pad64[l] / kChunk;
  w.nch = L.pad64[l + 1] / kChunk;
  w.c0 = rank * w.nch / L.cluster;
  w.c1 = (rank + 1) * w.nch / L.cluster;
  return w;
}

// What a consumer warpgroup's pass reads besides its accumulators.
struct Pass {
  uint32_t cur, nxt, ring, full_bar, empty_bar;   // shared addresses
  int stages, stage_bytes, nk, cs, wg, O, R, row0, e;
  bool last;
  const float* bl;
  __nv_bfloat16* bias;                            // this warpgroup's, smem
  __nv_bfloat16* out;
};

// One pass of a consumer warpgroup: NC column chunks from chunk p.cs of one
// layer, over all its K-slabs, then the epilogue.  NC is a template
// argument so that the wgmma sequence is straight-line code and nothing
// else touches the accumulators while the MMAs are in flight.
template <int TM, int NC>
__device__ __forceinline__ void consume_pass(const Pass& p, int& it) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int wrow = p.wg * 64;
  // the pass's biases into shared memory, their latency behind the K loop
  // (the barrier: the previous pass's epilogue has read the old ones)
  warpgroup_bar(p.wg);
  for (int i = threadIdx.x % 128; i < NC * kChunk; i += 128) {
    const int col = p.cs * kChunk + i;
    p.bias[i] = __float2bfloat16(col < p.O ? __ldg(p.bl + col) : 0.f);
  }
  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  int prev = 0;
  for (int ks = 0; ks < p.nk; ++ks, ++it) {
    const int s = it % p.stages;
    mbar_wait(p.full_bar + 8 * s, (it / p.stages) & 1);
    __syncwarp();
    wgmma_fence();
    const uint32_t a_base = p.cur + ks * TM * 128 + wrow * 128;
    const uint32_t b_base = p.ring + s * p.stage_bytes;
#pragma unroll
    for (int k16 = 0; k16 < 4; ++k16) {
      const uint64_t da = sw128_desc(a_base + k16 * 32);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        wgmma_64x64(acc[c], da,
                    sw128_desc(b_base + c * kChunkBytes + k16 * 32));
    }
    wgmma_commit();
    if (ks > 0) {
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(p.empty_bar + 8 * prev);
    }
    prev = s;
  }
  wgmma_wait<0>();
  if (lane == 0) mbar_arrive(p.empty_bar + 8 * prev);

  // epilogue: bias + SELU in f32 on the accumulators, then one rounding to
  // bf16 on the way out.  It runs once per pass, so each of its instructions
  // is fetched anew: short unrolled loops, branch-free SELU.
  warpgroup_bar(p.wg);
  const int q8 = lane / 4, r_lo = wrow + warp * 16 + q8;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bb =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              p.bias + c * kChunk + j * 8 + (lane % 4) * 2));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[c][4 * j + 2 * h] = selu_fast(acc[c][4 * j + 2 * h] + bb.x);
        acc[c][4 * j + 2 * h + 1] = selu_fast(acc[c][4 * j + 2 * h + 1] + bb.y);
      }
    }
  const int col0 = p.cs * kChunk + (lane % 4) * 2;
  if (p.last) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = p.row0 + r_lo + 8 * h;
      if (gr >= p.R) continue;
      __nv_bfloat16* o = p.out + ((long long)p.e * p.R + gr) * p.O;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = col0 + c * kChunk + j * 8;
          if (col < p.O) o[col] = __float2bfloat16(acc[c][4 * j + 2 * h]);
          if (col + 1 < p.O)
            o[col + 1] = __float2bfloat16(acc[c][4 * j + 2 * h + 1]);
        }
    }
    return;
  }
  // into the next activation buffer: row r_lo + 8 h, column pair col0 + ...
  // lands in 16-byte group j ^ (row % 8) of its 64-column chunk
  const uint32_t base = p.nxt + (uint32_t)(r_lo * 128 + (lane % 4) * 4);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(
                         base + (p.cs + c) * TM * 128 + h * 1024 +
                         ((j ^ q8) << 4)),
                     "r"(pack_bf16(acc[c][4 * j + 2 * h],
                                   acc[c][4 * j + 2 * h + 1])));
}

template <int TM>
__global__ void __launch_bounds__(TM * 2 + 32)
fused_enn_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ slabs,
                       const float* __restrict__ b,
                       __nv_bfloat16* __restrict__ out, int R, Layout L) {
  constexpr int kWarpgroups = TM / 64;
  extern __shared__ unsigned char smem_raw[];
  // 1,024-byte alignment: the swizzle atoms' base, for wgmma and the image
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t act0 = smem_addr(smem), act1 = act0 + L.act_bytes[0];
  const uint32_t ring = act1 + L.act_bytes[1];
  const uint32_t full_bar = ring + L.stages * L.stage_bytes;
  const uint32_t empty_bar = full_bar + 8 * kMaxStages;
  // two layer barriers, alternating: a peer one layer ahead arrives on the
  // other one, never on the phase this block still waits for
  const uint32_t layer_bar = empty_bar + 8 * kMaxStages;
  __nv_bfloat16* bias_smem = reinterpret_cast<__nv_bfloat16*>(
      smem + (layer_bar + 16 - act0) + (threadIdx.x / 128) * (kBiasBytes / 2));

  const int C = L.cluster;
  const int rank = C > 1 ? (int)cluster_rank() : 0;
  const int e = blockIdx.y;
  const int row0 = (blockIdx.x / C) * TM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L.stages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 4 * kWarpgroups);
    }
    mbar_init(layer_bar, 1);
    mbar_init(layer_bar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every peer's barriers exist before anyone arrives on them
  if (C > 1) cluster_sync_all(); else __syncthreads();

  if (warp == 4 * kWarpgroups) {
    // ---- producer: one thread streams every slab through the ring ----
    if (lane == 0) {
      int it = 0;
      long long off = 0;
      for (int l = 0; l < L.n_layers; ++l) {
        const LayerWork w = layer_work(L, l, rank);
        const __nv_bfloat16* wl =
            slabs + off + (long long)e * w.nk * w.nch * (kChunk * kChunk);
        for (int cs = w.c0; cs < w.c1; cs += kMaxChunks) {
          const int nc = min(kMaxChunks, w.c1 - cs);
          for (int ks = 0; ks < w.nk; ++ks, ++it) {
            const int s = it % L.stages, n = it / L.stages;
            if (n > 0) mbar_wait(empty_bar + 8 * s, (n - 1) & 1);
            mbar_expect_tx(full_bar + 8 * s, nc * kChunkBytes);
            bulk_load(ring + s * L.stage_bytes,
                      wl + ((long long)ks * w.nch + cs) * (kChunk * kChunk),
                      nc * kChunkBytes, full_bar + 8 * s);
          }
        }
        off += (long long)gridDim.y * w.nk * w.nch * (kChunk * kChunk);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) ----
    const int wg = warp / 4, t = threadIdx.x % 128;
    const int wrow = wg * 64;
    {
      // the input tile, zero-filled; rows of I bf16 are not 16-byte
      // aligned, so plain loads: a thread walks one column down its
      // warpgroup's 64 rows, kBatch loads in flight
      constexpr int kBatch = 32;
      const int I = L.dims[0], Ip = L.pad64[0];
      for (int c = t; c < Ip; c += 128) {
        for (int r0 = 0; r0 < 64; r0 += kBatch) {
          __nv_bfloat16 v[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int gr = row0 + wrow + r0 + u;
            v[u] = c < I && gr < R ? x[(long long)gr * I + c]
                                   : __float2bfloat16(0.f);
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            *reinterpret_cast<__nv_bfloat16*>(
                smem + swz_offset(wrow + r0 + u, c, TM)) = v[u];
        }
      }
      fence_async_cta();
      warpgroup_bar(wg);
    }

    int it = 0, syncs = 0;
    for (int l = 0; l < L.n_layers; ++l) {
      const LayerWork w = layer_work(L, l, rank);
      const uint32_t cur = l & 1 ? act1 : act0, nxt = l & 1 ? act0 : act1;
      const bool last = l == L.n_layers - 1;
      const int O = L.dims[l + 1];
      const float* bl = b + L.b_off[l] + (long long)e * L.pads[l + 1];
      const Pass pass = {cur, nxt, ring, full_bar, empty_bar, L.stages,
                         L.stage_bytes, w.nk, 0, wg, O, R, row0, e, last, bl,
                         bias_smem, out};
      for (int cs = w.c0; cs < w.c1; cs += kMaxChunks) {
        Pass pc = pass;
        pc.cs = cs;
        switch (min(kMaxChunks, w.c1 - cs)) {
          case 1: consume_pass<TM, 1>(pc, it); break;
          case 2: consume_pass<TM, 2>(pc, it); break;
          case 3: consume_pass<TM, 3>(pc, it); break;
          default: consume_pass<TM, 4>(pc, it); break;
        }
      }
      if (last) break;
      // the next layer reads what every block of the cluster just wrote
      if (C == 1) {
        fence_async_cta();
        warpgroup_bar(wg);
      } else {
        // one bulk copy of this block's chunks to each peer, completing on
        // the peer's layer barrier; then expect what the peers send here
        fence_async_cta();
        warpgroup_bar(wg);
        const uint32_t bar = layer_bar + 8 * (syncs & 1);
        if (t == 0) {
          const uint32_t mine = nxt + w.c0 * TM * 128;
          const int nb = w.c1 - w.c0;
          if (nb > 0)
            for (int q = 0; q < C; ++q)
              if (q != rank)
                bulk_to_peer(map_to_rank(mine, q), mine, nb * TM * 128,
                             map_to_rank(bar, q));
          mbar_expect_tx(bar, (w.nch - nb) * TM * 128);
        }
        mbar_wait_cluster(bar, (syncs >> 1) & 1);
        __syncwarp();
      }
      ++syncs;
    }
  }
  // no block leaves while a peer may still reach into its shared memory
  if (C > 1) cluster_sync_all();
}

// ---------------------------------------------------------------- host ----

int pad_to(int n, int m) { return (n + m - 1) / m * m; }

// Shared memory of the wgmma kernel; mirrored by fused_enn.smem_plan in
// the wrapper.  Buffer 0 holds the input and the outputs of odd layers,
// buffer 1 those of even layers; the last layer's output never lands in
// shared memory.  Returns the total bytes, or -1 if fewer than 2 stages fit.
int plan_smem(Layout& L, int tile) {
  const int n = L.n_layers;
  int width[2] = {L.pad64[0], 0};
  int chunks = 1;
  for (int l = 0; l < n; ++l) {
    if (l < n - 1) {
      int& wd = width[(l + 1) & 1];
      if (L.pad64[l + 1] > wd) wd = L.pad64[l + 1];
    }
    const int per_block = (L.pad64[l + 1] / kChunk + L.cluster - 1) / L.cluster;
    chunks = max(chunks, min(kMaxChunks, per_block));
  }
  L.act_bytes[0] = tile * width[0] * 2;
  L.act_bytes[1] = tile * width[1] * 2;
  L.stage_bytes = chunks * kChunkBytes;
  const int fixed =
      L.act_bytes[0] + L.act_bytes[1] + kBarrierBytes + kBiasBytes + 1024;
  L.stages = min(kMaxStages, (kMaxSmem - fixed) / L.stage_bytes);
  if (L.stages < 2) return -1;
  return fixed + L.stages * L.stage_bytes;
}

template <int TM>
cudaError_t launch_wgmma(const void* x, const void* slabs, const void* b,
                         void* out, int R, int E, Layout L, int smem,
                         cudaStream_t stream) {
  auto kernel = fused_enn_wgmma_kernel<TM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((R + TM - 1) / TM * L.cluster, E);
  cfg.blockDim = dim3(TM * 2 + 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (L.cluster > 1) {
    // C blocks of this much shared memory must fit on the card together
    static int checked[kMaxCluster + 1][2] = {};
    int& ok = checked[L.cluster][TM / 64 - 1];
    if (ok < smem) {
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (err != cudaSuccess) return err;
      if (clusters < 1) return cudaErrorInvalidConfiguration;
      ok = smem;
    }
  }
  err = cudaLaunchKernelEx(&cfg, kernel,
                           static_cast<const __nv_bfloat16*>(x),
                           static_cast<const __nv_bfloat16*>(slabs),
                           static_cast<const float*>(b),
                           static_cast<__nv_bfloat16*>(out), R, L);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* x, const void* w, const void* b, void* out,
                       int R, int E, const Layout& L, cudaStream_t stream) {
  auto kernel = fused_enn_f32_kernel<kTileF32>;
  const size_t smem = 2 * (size_t)kTileF32 * L.lda * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + kTileF32 - 1) / kTileF32, E);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(out), R, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  dims: n_layers + 1 true widths.
// x (R, dims[0]); b: per layer (E, Op16_l) f32 biases already rounded
// through the compute dtype; out (E, R, dims[n_layers]).
// w, f32: per layer (E, Kp16_l, Op16_l) transposed zero-padded weights,
// layers back to back.  w, bf16: the swizzled slab image (fused_enn.py,
// slab_image).  tile_rows (64 or 128) and cluster (1, 2, 4, 8; 1 when
// tile_rows is 128) are the bf16 launch plan (fused_enn.launch_plan); f32
// ignores them.
int fused_enn_forward(int dtype, const void* x, const void* w, const void* b,
                      void* out, int R, int E, int n_layers, const int* dims,
                      int tile_rows, int cluster, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || R < 1 || E < 1 || E > 65535)
    return (int)cudaErrorInvalidValue;
  Layout L;
  L.n_layers = n_layers;
  int max_pad = 0;
  for (int i = 0; i <= n_layers; ++i) {
    if (dims[i] < 1) return (int)cudaErrorInvalidValue;
    L.dims[i] = dims[i];
    L.pads[i] = pad_to(dims[i], 16);
    L.pad64[i] = pad_to(dims[i], kChunk);
    if (L.pads[i] > max_pad) max_pad = L.pads[i];
  }
  long long w_off = 0, b_off = 0;
  for (int l = 0; l < n_layers; ++l) {
    L.w_off[l] = w_off;
    L.b_off[l] = b_off;
    w_off += (long long)E * L.pads[l] * L.pads[l + 1];
    b_off += (long long)E * L.pads[l + 1];
  }
  L.lda = max_pad + 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_f32(x, w, b, out, R, E, L, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const bool ok_plan = (tile_rows == 64 && (cluster == 1 || cluster == 2 ||
                                            cluster == 4 || cluster == 8)) ||
                       (tile_rows == 128 && cluster == 1);
  if (!ok_plan) return (int)cudaErrorInvalidValue;
  L.cluster = cluster;
  const int smem = plan_smem(L, tile_rows);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  if (tile_rows == 128)
    return (int)launch_wgmma<128>(x, w, b, out, R, E, L, smem, s);
  return (int)launch_wgmma<64>(x, w, b, out, R, E, L, smem, s);
}

const char* fused_enn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
