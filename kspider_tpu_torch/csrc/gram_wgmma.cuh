// The Gram kernel's body, shared by its two forms (gram_int8.cu,
// gram_bf16.cu), and the PTX helpers it is built from.
//
// Both forms compute, over a list of 128x128 output tile pairs,
//
//   out[l, i, j] += sum_c bit_i[c, i] * w_l[c] * bit_j[c, j]
//
// from the JAX package's transposed layout, colors contiguous:
//   bits   u8[NB, n_pad/8, block]  byte r of color c holds samples 8r..8r+7,
//                                  most significant bit first
//   w      i8[NB, L, block]        base-128 weight limbs, each in [0, 127]
//   out   i32[L, npad_i, npad_j]   accumulated in place (out += the sums)
//
// The design, per chunk of one tile (a chunk is exactly one 128-byte
// K-major B row per sample: 128 s8 colors, or 64 bf16 colors):
//  - products: wgmma m64n128, A from registers, B from shared memory.  Two
//    warpgroups own rows 0..63 and 64..127 of the tile.  The limb sits on
//    the A side: acc_l = (bit_i * w_l)^T . bit_j.
//  - B (the 0/1 j side) is unpacked once per chunk into shared memory in
//    the canonical K-major layout with the 128-byte swizzle, and read by
//    every limb and both warpgroups.
//  - A is built in registers straight from the packed bytes and the limbs,
//    in wgmma's A fragment layout (the form's build_a).
//  - the packed bits and limbs come through a ring of stages, filled with
//    16-byte cp.async by the CTA's threads, each stage with its mbarrier
//    (one arrival per thread).  One cp.async.bulk per 128-byte row (34 a
//    chunk, from one warp) held an int8 chunk to ~3,800 cycles on an H100.
//  - the tensor pipe never drains inside an item: chunk k's wgmmas stay in
//    flight across the chunk barrier (wgmma.wait_group 1), while the CTA
//    unpacks chunk k+1's B into the third of three B buffers and builds its
//    A fragments into the register set chunk k-1 used.
//  - persistence: one launch, one CTA per SM.  A CTA walks its tile pairs
//    and, inside each pair, its limb groups: limbs two at a time (2 x 64
//    accumulators per thread), then, for an odd L, a second pass over its
//    pairs for the last limb with one accumulator.  The ring runs on across
//    items and passes, so the next item's loads overlap this item's
//    epilogue (out += acc, int32 read-add-write).
//  - every limb group streams and unpacks the packed bits again.  Sharing
//    one unpacked B across more than two limbs would need all their
//    accumulators at once: 64 KB per limb of a 128 x 128 tile, so L = 3 is
//    192 of a thread's 255 registers before any A fragment.
//
// A form F supplies:
//   Acc            accumulator element (uint32_t for s32 sums, float for f32)
//   kChunk         colors per chunk
//   kKSteps        wgmma k steps per chunk, each 32 bytes along a B row
//   kStages        ring depth
//   kLimbs         offset of the int8 limb rows (kChunk bytes each) in a
//                  stage, after the i and j bits (kTile / 8 rows of kChunk)
//   kStageBytes    bytes of a ring stage (a multiple of 16)
//   kPrepAhead     1: a stage is waited for when it is unpacked; 2: one step
//                  earlier, when prep<G> readies its limbs for build_a
//   kSegments      whether the sums are also flushed every Args::segment
//                  chunks of an item
//   mma(d, a, desc_b, accumulate)   d[64] = A . B + (accumulate ? d : 0)
//   unpack_b(jbits, b)              the stage's j bits into B
//   build_a<G>(stage, a)            this thread's A fragments
//   prep<G>(stage)                  (kPrepAhead 2) the limbs, for build_a
//   add_out(p, x, y)                p[0] += x, p[1] += y: volatile asm
//                                   that only reads x and y

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gram {

constexpr int kTile = 128;      // output tile edge (samples)
constexpr int kThreads = 256;   // two warpgroups
constexpr int kBBytes = kTile * 128;  // unpacked B of one chunk

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// 16 bytes from global to shared memory (both addresses 16-byte aligned),
// through L2 only
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(dst), "l"(src) : "memory");
}

// one arrival on the mbarrier once this thread's earlier cp.asyncs landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// waits until at most N committed groups of products are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keeps the compiler from reusing registers that asynchronous products
// still read.  Never applied to accumulators inside the loop: a definition
// there makes ptxas wait for the products (C7517).
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
  #pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// Shared-memory matrix descriptor of a K-major operand with the 128-byte
// swizzle: 8-row groups of 128-byte rows, 1024 bytes apart (stride byte
// offset); the leading byte offset is unused for this layout (set to 1).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

// A launch's arguments.  bits_j may equal bits_i; out is read and written.
struct Args {
  const uint8_t* bits_i;
  const uint8_t* bits_j;
  const int8_t* wl;
  const int32_t* tile_i;
  const int32_t* tile_j;
  int32_t* out;
  int num_pairs, n_blocks, block, n_limbs, npad_i, npad_j;
  int segment;  // chunks between flushes, for a form with kSegments
};

// Dynamic shared memory of form F, from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 8 rows of 128 bytes): three B buffers,
// the ring of stages, one mbarrier per stage.
template <class F>
struct Smem {
  static constexpr int kRing = 3 * kBBytes;
  static constexpr int kBars = kRing + F::kStages * F::kStageBytes;
  static constexpr int kAlloc = kBars + F::kStages * 8 + 1024;  // room to align
  static_assert(F::kStageBytes % 16 == 0, "stages stay 16-byte aligned");
};

template <class F, int G>
__device__ __forceinline__ void fence_a(uint32_t (&a)[F::kKSteps][G][4]) {
  #pragma unroll
  for (int s = 0; s < F::kKSteps; ++s)
    #pragma unroll
    for (int l = 0; l < G; ++l) fence_regs(a[s][l]);
}

// One pass of a CTA over its tile pairs blockIdx.x, + gridDim.x, ..., each
// pair's n_groups groups of G limbs in turn (group g: limbs limb0 + G g
// .. + G - 1).  Item m of the pass is (pair m / n_groups, group
// m % n_groups).  The pass streams its chunks through the ring from ring
// position q0 (which sets each stage's slot and mbarrier parity) and
// returns the position after it.
template <class F, int G>
__device__ __forceinline__ int gram_pass(const Args& a, uint8_t* bbuf,
                                         uint8_t* ring, uint32_t bars,
                                         int n_groups, int limb0, int q0) {
  constexpr int kChunk = F::kChunk, kKSteps = F::kKSteps;
  constexpr int kStages = F::kStages, kStageBytes = F::kStageBytes;
  constexpr int kSideBytes = (kTile / 8) * kChunk;  // packed bits of one side
  constexpr int kPieces = kChunk / 16;  // 16-byte pieces of a byte row
  const int tid = threadIdx.x;
  const int my_pairs = (a.num_pairs - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int n_chunks = a.n_blocks * (a.block / kChunk);
  const int total = my_pairs * n_groups * n_chunks;  // chunks of this pass
  const int n8_i = a.npad_i / 8, n8_j = a.npad_j / 8;
  const uint32_t ring_u32 = smem_u32(ring);
  auto pair_of = [&](int m) { return blockIdx.x + (m / n_groups) * gridDim.x; };
  auto limb_of = [&](int m) { return limb0 + G * (m % n_groups); };

  // The load cursor: the next chunk to copy is chunk (ld_b, ld_c0) of this
  // pass's item ld_m.  Threads below 32 kPieces copy piece tid of a
  // stage's bits (16 bytes): byte row tid / kPieces (rows 0..15 the i
  // side, 16..31 the j side; the others copy no bits); threads below
  // kPieces G also copy piece tid of the G limb rows.
  const int my_row = tid / kPieces, my_col = 16 * (tid % kPieces);
  const uint8_t* side = my_row < 16 ? a.bits_i : a.bits_j;
  const int side_n8 = my_row < 16 ? n8_i : n8_j;
  const int32_t* side_tiles = my_row < 16 ? a.tile_i : a.tile_j;
  int ld_q = 0, ld_m = 0, ld_b = 0, ld_c0 = 0;
  long long ld_row = 0;  // this thread's byte row of block 0 of item ld_m
  int ld_limb = 0;
  auto set_load_item = [&]() {
    ld_row = side_tiles[pair_of(ld_m)] * (kTile / 8) + (my_row % 16);
    ld_limb = limb_of(ld_m);
  };
  // copies the next chunk into its stage, arrives once on the stage's
  // mbarrier, and advances the cursor
  auto issue = [&]() {
    const int s = (q0 + ld_q) % kStages;
    const uint32_t stage = ring_u32 + s * kStageBytes;
    if (32 * kPieces == kThreads || tid < 32 * kPieces)
      cp_async16(stage + 16 * tid,
                 side + ((long long)ld_b * side_n8 + ld_row) * a.block + ld_c0 + my_col);
    if (tid < kPieces * G)
      cp_async16(stage + F::kLimbs + 16 * tid,
                 a.wl + ((long long)ld_b * a.n_limbs + ld_limb + tid / kPieces) * a.block
                    + ld_c0 + my_col);
    cp_async_arrive(bars + 8 * s);
    ++ld_q;
    ld_c0 += kChunk;
    if (ld_c0 == a.block) {
      ld_c0 = 0;
      if (++ld_b == a.n_blocks) {
        ld_b = 0;
        if (++ld_m < my_pairs * n_groups) set_load_item();
      }
    }
  };
  auto stage_at = [&](int q) { return ring + ((q0 + q) % kStages) * kStageBytes; };
  auto stage_ready = [&](int q) {
    mbar_wait(bars + 8 * ((q0 + q) % kStages), ((q0 + q) / kStages) & 1);
    return stage_at(q);
  };

  typename F::Acc acc[G][64];
  #pragma unroll
  for (int l = 0; l < G; ++l)
    #pragma unroll
    for (int i = 0; i < 64; ++i) acc[l][i] = 0;

  // out[limb, tile rows, tile cols] += acc for item m, after all its
  // products are done.  Accumulator element i of thread lane 4g + t in warp
  // w of warpgroup h: row 64h + 16w + g + 8 (i/2 % 2), column 8 (i / 4) +
  // 2t + i % 2.  F::add_out is volatile asm that only reads the
  // accumulators, so it stays after the wait and nothing outside the
  // products defines them.
  auto epilogue = [&](int m) {
    const int pair = pair_of(m);
    const int limb = limb_of(m);
    const int lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = 16 * (tid / 32) + g;  // 64h + 16w + g
    #pragma unroll
    for (int l = 0; l < G; ++l) {
      int32_t* tile = a.out + (long long)(limb + l) * a.npad_i * a.npad_j
                      + (long long)(a.tile_i[pair] * kTile + row0) * a.npad_j
                      + a.tile_j[pair] * kTile + 2 * t;
      #pragma unroll
      for (int i = 0; i < 64; i += 2)
        F::add_out(tile + (long long)(8 * ((i / 2) % 2)) * a.npad_j + 8 * (i / 4),
                   acc[l][i], acc[l][i + 1]);
    }
  };

  // With kPrepAhead 2, chunk q's stage is waited for and its limbs readied
  // two steps ahead (in step q - 2, the prologue for chunks 0 and 1).
  uint32_t a0[kKSteps][G][4], a1[kKSteps][G][4];
  if (total > 0) {
    set_load_item();
    for (int q = 0; q < kStages && q < total; ++q) issue();
    if constexpr (F::kPrepAhead == 2) {
      F::template prep<G>(stage_ready(0));
      if (total > 1) F::template prep<G>(stage_ready(1));
      __syncthreads();
    }
    const uint8_t* st = F::kPrepAhead == 2 ? stage_at(0) : stage_ready(0);
    F::unpack_b(st + kSideBytes, bbuf);
    F::template build_a<G>(st, a0);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
  }

  // Chunk q: its products are issued on B buffer q % 3 with A registers
  // cur and stay in flight across the chunk barrier; once chunk q - 1's
  // products are done (wait_group 1), chunk q + 1 is unpacked into B
  // buffer (q + 1) % 3, last read by chunk q - 2, and built into nxt,
  // chunk q - 1's A registers.  The last chunk of an item (or of a
  // segment) waits for all products and adds the accumulators into out;
  // the next chunk's first product restarts them (scale-d 0).
  int cm = 0, cc = 0, cs = 0;  // item, chunk in the item, chunk in the segment
  auto step = [&](int q, uint32_t (&cur)[kKSteps][G][4],
                  uint32_t (&nxt)[kKSteps][G][4]) {
    const uint32_t b_addr = smem_u32(bbuf + (q % 3) * kBBytes);
    const uint32_t first = F::kSegments ? cs == 0 : cc == 0;
    wgmma_fence();
    #pragma unroll
    for (int s = 0; s < kKSteps; ++s)
      #pragma unroll
      for (int l = 0; l < G; ++l)
        F::mma(acc[l], cur[s][l], desc_sw128(b_addr + 32 * s), s > 0 || !first);
    wgmma_commit();
    if (ld_q < total) issue();
    wgmma_wait<1>();
    fence_a<F, G>(nxt);
    if (q + 1 < total) {
      const uint8_t* st = F::kPrepAhead == 2 ? stage_at(q + 1) : stage_ready(q + 1);
      F::unpack_b(st + kSideBytes, bbuf + ((q + 1) % 3) * kBBytes);
      F::template build_a<G>(st, nxt);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    if constexpr (F::kPrepAhead == 2)
      if (q + 2 < total) F::template prep<G>(stage_ready(q + 2));
    if (q < total) {
      const bool item_done = ++cc == n_chunks;
      if (F::kSegments) ++cs;
      if (item_done || (F::kSegments && cs == a.segment)) {
        wgmma_wait<0>();
        epilogue(cm);
        cs = 0;
        if (item_done) {
          cc = 0;
          ++cm;
        }
      }
    }
    __syncthreads();
  };

  // Two steps a trip, both unconditional: a step under a condition makes
  // the accumulators' values join from two paths, and ptxas then waits for
  // the products at every chunk (C7517).  An odd count gets one step more,
  // on stale operands, whose sums are never written out.
  for (int q = 0; q < total; q += 2) {
    step(q, a0, a1);
    step(q + 1, a1, a0);
  }
  // every warpgroup's products are done before the next pass unpacks
  wgmma_wait<0>();
  __syncthreads();
  return q0 + total;
}

// The kernel's body, for gridDim.x <= num_pairs and Smem<F>::kAlloc bytes
// of dynamic shared memory: limbs in pairs, then an odd last limb alone.
// L = 1 has an instantiation of its own (kPairs false): compiled beside the
// two-limb pass, the int8 one-limb pass ran 8-9% slower on an H100 (700 W).
template <class F, bool kPairs>
__device__ __forceinline__ void gram_kernel(const Args& a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t bars = smem_u32(smem + Smem<F>::kBars);
  if (threadIdx.x == 0) {
    for (int s = 0; s < F::kStages; ++s) mbar_init(bars + 8 * s, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int q = 0;
  if (kPairs)
    q = gram_pass<F, 2>(a, smem, smem + Smem<F>::kRing, bars, a.n_limbs / 2, 0, q);
  if (a.n_limbs % 2)
    gram_pass<F, 1>(a, smem, smem + Smem<F>::kRing, bars, 1, a.n_limbs - 1, q);
}

// Launches kernel (a __global__ wrapper of gram_kernel<F, ...>) with one
// CTA per SM, at most one per tile pair; returns the first CUDA error.
template <class F, class Kernel>
int launch(Kernel kernel, const Args& a, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Smem<F>::kAlloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = a.num_pairs < sms ? a.num_pairs : sms;
  kernel<<<grid, kThreads, Smem<F>::kAlloc, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gram
