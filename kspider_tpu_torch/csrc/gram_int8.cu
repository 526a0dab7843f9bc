// Weighted Gram tiles from packed membership bits, int8 form, on Hopper's
// warpgroup tensor-core products (wgmma).
//
// Replaces the int8 form of the four Pallas kernels of
// kspider_tpu/ops/pallas_pairwise.py: cooccurrence_pallas (full square),
// cooccurrence_pallas_rect (two panels), cooccurrence_pallas_tri (explicit
// upper-triangle tile list) and cooccurrence_pallas_sym (upper strips,
// mirrored afterwards).  All four compute, over a set of output tiles,
//
//   out[l, i, j] += sum_c bit_i[c, i] * w_l[c] * bit_j[c, j]
//
// and here they are one kernel driven by a list of 128x128 tile pairs:
// every launch mode (all tiles of a rectangle, upper tiles of one panel, any
// other list) is just a list.  The bf16 form is csrc/gram_bf16.cu.
//
// Layout (the JAX package's transposed one, colors contiguous):
//   bits   u8[NB, n_pad/8, block]  byte r of color c holds samples 8r..8r+7,
//                                  most significant bit first
//   w      i8[NB, L, block]        base-128 weight limbs, each in [0, 127]
//   out   i32[L, npad_i, npad_j]   accumulated in place (out += the sums)
//
// Bound: operations.  Each packed byte feeds 8 x 128 x 2 MACs per limb, far
// above the card's ops:byte ratio, so the kernel is bound by the tensor
// cores (1,979 int8 TOP/s dense on an H100 SXM), not by memory.
//
// Design, per 128-color chunk of one tile (a chunk is exactly one 128-byte
// K-major row per sample):
//  - products: wgmma m64n128k32 s8 x s8 -> s32.  Two warpgroups own rows
//    0..63 and 64..127 of the tile.  The limb sits on the A side, which
//    lives in registers: acc_l = (bit_i * w_l)^T . bit_j.
//  - B (the 0/1 j side) is unpacked once per chunk into shared memory in
//    the canonical K-major layout with the 128-byte swizzle, and read by
//    every limb and both warpgroups.
//  - A is built in registers straight from the packed bytes and the limb
//    bytes, in wgmma's A fragment layout: (word >> (7 - p)) & 0x01010101
//    gives 4 colors' bits of sample p as 4 bytes, times 0xFF masks the 4
//    limb bytes.
//  - the packed bits and limbs (2 KB per side and 128 B per limb) come
//    through a ring of kStages stages, filled with 16-byte cp.async by all
//    threads, each stage with its mbarrier (one arrival per thread).  One
//    cp.async.bulk per 128-byte row (34 a chunk, from one warp) held a
//    chunk to ~3,800 cycles on an H100.
//  - the tensor pipe never drains inside an item: chunk k's wgmmas stay in
//    flight across the chunk barrier (wgmma.wait_group 1), while the CTA
//    unpacks chunk k+1's B into the third of three B buffers and builds its
//    A fragments into the register set chunk k-1 used.
//  - persistence: one launch, one CTA per SM.  A CTA walks its tile pairs
//    and, inside each pair, its limb groups: limbs two at a time (2 x 64
//    int32 accumulators per thread), then, for an odd L, a second pass over
//    its pairs for the last limb with one accumulator.  The ring runs on
//    across items and passes, so the next item's loads overlap this item's
//    epilogue (out += acc, int32 read-add-write).
//  - every limb group streams and unpacks the packed bits again.  Sharing
//    one unpacked B across more than two limbs would need all their
//    accumulators at once: 64 KB per limb of a 128 x 128 tile, so L = 3 is
//    192 of a thread's 255 registers before any A fragment.
//
// On an H100 (700 W) this reaches 53-56% of the int8 bound at the main
// path's shapes.  What holds it there is shared memory, shared by the
// products' B reads (64 KB a chunk at L = 2) and the unpack and A build;
// a deeper product queue needs a third A register set, which does not fit
// beside 128 accumulators (246 of 255 registers).
//
// Exactness: a limb term is at most 127 per color and the caller bounds the
// colors per accumulation (_MAX_COLORS_PER_CALL), so int32 never wraps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;      // output tile edge (samples)
constexpr int kChunk = 128;     // colors per chunk: one 128-byte B row
constexpr int kStages = 4;      // packed-input ring depth
constexpr int kThreads = 256;   // two warpgroups
constexpr int kKSteps = kChunk / 32;             // wgmma k32 steps per chunk
constexpr int kSideBytes = (kTile / 8) * kChunk;  // packed bits of one side
constexpr int kBBytes = kTile * kChunk;           // unpacked B of one chunk

// Dynamic shared memory, from a 1024-byte aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes): three B buffers, the ring of
// packed stages (i bits, j bits, two limb rows), one mbarrier per stage.
constexpr int kStageBytes = 2 * kSideBytes + 2 * kChunk;
constexpr int kRing = 3 * kBBytes;
constexpr int kBars = kRing + kStages * kStageBytes;
constexpr int kSmemAlloc = kBars + kStages * 8 + 1024;  // room to align

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

// d[64] = A (64x32 s8, registers) . B (32x128 s8, shared memory)
//         + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_m64n128k32(uint32_t (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b,
                                                 uint32_t accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// Unpacks the j side of one stage (16 byte rows x 128 colors) into B: row
// n = 8r + p holds bit (7 - p) of byte row r, one byte per color, with the
// 16-byte column group c stored at group c ^ (n % 8).  Each thread turns 16
// colors of one byte row into 4 of its 8 sample rows.
__device__ __forceinline__ void unpack_b(const uint8_t* __restrict__ jbits,
                                         uint8_t* __restrict__ b) {
  const int u = threadIdx.x % 128;
  const int r = u / 8;           // byte row
  const int grp = u % 8;         // 16-color group
  const int p0 = 4 * (threadIdx.x / 128);
  const uint4 w = *reinterpret_cast<const uint4*>(jbits + r * kChunk + grp * 16);
  #pragma unroll
  for (int pp = 0; pp < 4; ++pp) {
    const int p = p0 + pp;
    const int sh = 7 - p;
    uint4 v;
    v.x = (w.x >> sh) & 0x01010101u;
    v.y = (w.y >> sh) & 0x01010101u;
    v.z = (w.z >> sh) & 0x01010101u;
    v.w = (w.w >> sh) & 0x01010101u;
    *reinterpret_cast<uint4*>(b + (8 * r + p) * kChunk + ((grp ^ p) * 16)) = v;
  }
}

// This thread's A fragments of one stage, for each k32 step and limb.  In
// wgmma's 8-bit A layout a warp holds 16 rows x 32 colors: lane 4g + t has
// row g in registers 0 and 2, row g + 8 in 1 and 3, colors 4t..4t+3 in 0
// and 1, 16 + 4t..16 + 4t + 3 in 2 and 3, one byte per color (lowest color
// in the lowest byte, as in the packed words).  Rows g and g + 8 of warp w
// in warpgroup h are bit (7 - g) of byte rows 8h + 2w and 8h + 2w + 1.
template <int G>
__device__ __forceinline__ void build_a(const uint8_t* __restrict__ stage,
                                        uint32_t (&a)[kKSteps][G][4]) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 2 * (threadIdx.x / 32);  // 8h + 2w
  const int sh = 7 - g;
  const uint8_t* ibits = stage;
  const uint8_t* limbs = stage + 2 * kSideBytes;
  #pragma unroll
  for (int s = 0; s < kKSteps; ++s) {
    const int lo = 32 * s + 4 * t, hi = lo + 16;
    uint32_t m[4];
    m[0] = *reinterpret_cast<const uint32_t*>(ibits + r0 * kChunk + lo);
    m[1] = *reinterpret_cast<const uint32_t*>(ibits + (r0 + 1) * kChunk + lo);
    m[2] = *reinterpret_cast<const uint32_t*>(ibits + r0 * kChunk + hi);
    m[3] = *reinterpret_cast<const uint32_t*>(ibits + (r0 + 1) * kChunk + hi);
    #pragma unroll
    for (int e = 0; e < 4; ++e) m[e] = ((m[e] >> sh) & 0x01010101u) * 0xFFu;
    #pragma unroll
    for (int l = 0; l < G; ++l) {
      const uint32_t wlo = *reinterpret_cast<const uint32_t*>(limbs + l * kChunk + lo);
      const uint32_t whi = *reinterpret_cast<const uint32_t*>(limbs + l * kChunk + hi);
      a[s][l][0] = m[0] & wlo;
      a[s][l][1] = m[1] & wlo;
      a[s][l][2] = m[2] & whi;
      a[s][l][3] = m[3] & whi;
    }
  }
}

template <int G>
__device__ __forceinline__ void fence_a(uint32_t (&a)[kKSteps][G][4]) {
  #pragma unroll
  for (int s = 0; s < kKSteps; ++s)
    #pragma unroll
    for (int l = 0; l < G; ++l) fence_regs(a[s][l]);
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
};

// One pass of a CTA over its tile pairs blockIdx.x, + gridDim.x, ..., each
// pair's n_groups groups of G limbs in turn (group g: limbs limb0 + G g
// .. + G - 1).  Item m of the pass is (pair m / n_groups, group
// m % n_groups).  The pass streams its chunks through the ring from ring
// position q0 (which sets each stage's slot and mbarrier parity) and
// returns the position after it.
template <int G>
__device__ __forceinline__ int gram_pass(const Args& a, uint8_t* bbuf,
                                         const uint8_t* ring, uint32_t bars,
                                         int n_groups, int limb0, int q0) {
  const int tid = threadIdx.x;
  const int my_pairs = (a.num_pairs - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int n_chunks = a.n_blocks * (a.block / kChunk);
  const int total = my_pairs * n_groups * n_chunks;  // chunks of this pass
  const int n8_i = a.npad_i / 8, n8_j = a.npad_j / 8;
  const uint32_t ring_u32 = smem_u32(ring);
  auto pair_of = [&](int m) { return blockIdx.x + (m / n_groups) * gridDim.x; };
  auto limb_of = [&](int m) { return limb0 + G * (m % n_groups); };

  // The load cursor: the next chunk to copy is chunk (ld_b, ld_c0) of this
  // pass's item ld_m.  Piece tid of a stage (16 bytes) is byte row tid / 8
  // (rows 0..15 the i side, 16..31 the j side), bytes 16 (tid % 8) ..;
  // threads below 8 G also copy piece tid of the G limb rows.
  const int my_row = tid / 8, my_col = 16 * (tid % 8);
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
    cp_async16(stage + 16 * tid,
               side + ((long long)ld_b * side_n8 + ld_row) * a.block + ld_c0 + my_col);
    if (tid < 8 * G)
      cp_async16(stage + 2 * kSideBytes + 16 * tid,
                 a.wl + ((long long)ld_b * a.n_limbs + ld_limb + tid / 8) * a.block
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
  auto stage_ready = [&](int q) {
    const int s = (q0 + q) % kStages;
    mbar_wait(bars + 8 * s, ((q0 + q) / kStages) & 1);
    return ring + s * kStageBytes;
  };

  uint32_t acc[G][64];
  #pragma unroll
  for (int l = 0; l < G; ++l)
    #pragma unroll
    for (int i = 0; i < 64; ++i) acc[l][i] = 0;

  // out[limb, tile rows, tile cols] += acc for item m, after all its
  // products are done.  Accumulator element i of thread lane 4g + t in warp
  // w of warpgroup h: row 64h + 16w + g + 8 (i/2 % 2), column 8 (i / 4) +
  // 2t + i % 2.  The read-add-write is volatile asm that only reads the
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
      for (int i = 0; i < 64; i += 2) {
        int32_t* p = tile + (long long)(8 * ((i / 2) % 2)) * a.npad_j + 8 * (i / 4);
        asm volatile(
            "{\n"
            ".reg .s32 x, y;\n"
            "ld.global.v2.s32 {x, y}, [%0];\n"
            "add.s32 x, x, %1;\n"
            "add.s32 y, y, %2;\n"
            "st.global.v2.s32 [%0], {x, y};\n"
            "}\n"
            :: "l"(p), "r"(acc[l][i]), "r"(acc[l][i + 1]) : "memory");
      }
    }
  };

  uint32_t a0[kKSteps][G][4], a1[kKSteps][G][4];
  if (total > 0) {
    set_load_item();
    for (int q = 0; q < kStages && q < total; ++q) issue();
    const uint8_t* st = stage_ready(0);
    unpack_b(st + kSideBytes, bbuf);
    build_a<G>(st, a0);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
  }

  // Chunk q: its products are issued on B buffer q % 3 with A registers
  // cur and stay in flight across the chunk barrier; once chunk q - 1's
  // products are done (wait_group 1), chunk q + 1 is unpacked into B
  // buffer (q + 1) % 3, last read by chunk q - 2, and built into nxt,
  // chunk q - 1's A registers.  The last chunk of an item waits for all
  // products and adds the accumulators into out.
  int cm = 0, cc = 0;  // item and chunk of chunk q
  auto step = [&](int q, uint32_t (&cur)[kKSteps][G][4],
                  uint32_t (&nxt)[kKSteps][G][4]) {
    const uint32_t b_addr = smem_u32(bbuf + (q % 3) * kBBytes);
    const uint32_t first = cc == 0;  // an item's first chunk starts at 0
    wgmma_fence();
    #pragma unroll
    for (int s = 0; s < kKSteps; ++s)
      #pragma unroll
      for (int l = 0; l < G; ++l)
        wgmma_m64n128k32(acc[l], cur[s][l], desc_sw128(b_addr + 32 * s),
                         s > 0 || !first);
    wgmma_commit();
    if (ld_q < total) issue();
    wgmma_wait<1>();
    fence_a<G>(nxt);
    if (q + 1 < total) {
      const uint8_t* st = stage_ready(q + 1);
      unpack_b(st + kSideBytes, bbuf + ((q + 1) % 3) * kBBytes);
      build_a<G>(st, nxt);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    if (q < total && ++cc == n_chunks) {
      wgmma_wait<0>();
      epilogue(cm);
      cc = 0;
      ++cm;
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

// Launch with gridDim.x <= num_pairs and kSmemAlloc bytes of dynamic
// shared memory: limbs in pairs, then an odd last limb alone.  L = 1 has an
// instantiation of its own (kPairs false): compiled beside the two-limb
// pass, the one-limb pass ran 8-9% slower on an H100 (700 W).
template <bool kPairs>
__global__ void __launch_bounds__(kThreads, 1)
gram_int8_wgmma_kernel(const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t bars = smem_u32(smem + kBars);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int q = 0;
  if (kPairs)
    q = gram_pass<2>(a, smem, smem + kRing, bars, a.n_limbs / 2, 0, q);
  if (a.n_limbs % 2)
    gram_pass<1>(a, smem, smem + kRing, bars, 1, a.n_limbs - 1, q);
}

template <bool kPairs>
int launch(const Args& a, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gram_int8_wgmma_kernel<kPairs>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemAlloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = a.num_pairs < sms ? a.num_pairs : sms;
  gram_int8_wgmma_kernel<kPairs><<<grid, kThreads, kSmemAlloc, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ks_gram_tile() { return kTile; }
int ks_gram_chunk() { return kChunk; }

// One kernel launch for any L.  Shapes are checked by the Python wrapper;
// returns the first CUDA error, so a refused launch is not silent.
int ks_gram_int8_tiles(const void* bits_i, const void* bits_j, const void* wl,
                       const void* tile_i, const void* tile_j, void* out,
                       int num_pairs, int n_blocks, int block, int n_limbs,
                       int npad_i, int npad_j, void* stream) {
  if (num_pairs <= 0 || n_limbs <= 0 || n_blocks <= 0 || block < kChunk)
    return static_cast<int>(cudaGetLastError());
  const Args a{static_cast<const uint8_t*>(bits_i),
               static_cast<const uint8_t*>(bits_j),
               static_cast<const int8_t*>(wl),
               static_cast<const int32_t*>(tile_i),
               static_cast<const int32_t*>(tile_j),
               static_cast<int32_t*>(out),
               num_pairs, n_blocks, block, n_limbs, npad_i, npad_j};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return n_limbs >= 2 ? launch<true>(a, st) : launch<false>(a, st);
}

}  // extern "C"
