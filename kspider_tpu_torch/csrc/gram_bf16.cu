// Weighted Gram tiles from packed membership bits, bf16 form, on Hopper's
// warpgroup tensor-core products (wgmma).
//
// Replaces the compute_dtype=bfloat16 form of the four Pallas kernels of
// kspider_tpu/ops/pallas_pairwise.py: cooccurrence_pallas (full square),
// cooccurrence_pallas_rect (two panels), cooccurrence_pallas_tri (explicit
// upper-triangle tile list) and cooccurrence_pallas_sym (upper strips,
// mirrored afterwards).  All four compute, over a set of output tiles,
//
//   out[l, i, j] += sum_c bit_i[c, i] * w_l[c] * bit_j[c, j]
//
// and here they are one kernel driven by a list of 128x128 tile pairs, as
// in the int8 form (csrc/gram_int8.cu), the one every CLI path runs; no CLI
// path sets this one.  The body, its layout and its design are shared with
// the int8 form in csrc/gram_wgmma.cuh; this file is the bf16 form's part.
//
// Bound: operations.  Each packed byte feeds 8 x 128 x 2 MACs per limb, far
// above the card's ops:byte ratio, so the kernel is bound by the tensor
// cores (989 bf16 TFLOP/s dense on an H100 SXM), not by memory.
//
// The form: 64-color chunks.  A chunk of 64 bf16 colors is one 128-byte
// K-major row per sample, as a 128-color s8 chunk is, so B keeps its
// 128-byte swizzle and descriptor, and a chunk's products at two limbs
// cost the same tensor time (1,024 cycles) as an int8 chunk's.
//  - products: wgmma m64n128k16 bf16 x bf16 -> f32.
//  - B: bf16 1.0 (0x3F80) or 0 per color of the j side.
//  - A: a color's bit, shifted to the top of its byte, becomes a 16-bit
//    mask by prmt's sign replication, and the mask selects the limb's
//    bf16.  The limbs are turned into bf16 once per chunk, two steps ahead,
//    into the chunk's ring stage (integers <= 127 are exact in bf16), so
//    the A build is two operations per color pair and row plus an AND per
//    limb: fewer than the int8 form's.
//  - a 6-stage ring: a stage is waited for two steps before its unpack.
//
// On an H100 (700 W) this reaches 50-52% of the bf16 bound at the main
// path's shapes with 64 or more color blocks, and 40% at the tiled
// off-diagonal pair (8 blocks); 250 of 255 registers at L >= 2.  PR 3's
// wmma kernel reached 12-13%.
//
// Exactness: every product is an integer <= 127 and the f32 accumulators
// restart at every segment of at most Args::segment chunks: wgmma's
// scale-d is 0 for a segment's first product, and at the segment's (or the
// item's) end the sums are rounded to int32 (exact) and added into out.
// The caller passes segment <= 2^24 / (127 * 64) = 2,064 chunks, so every
// partial sum is an integer of at most 16,776,192 < 2^24, exact in float32
// in any order of summation: on an H100 (700 W) one item of 2,064 chunks
// of every bit and limb 127 sums exactly to 16,776,192, and 2,096 chunks
// (one flush mid-item) to 17,036,288.  The caller bounds the colors per
// accumulation (_MAX_COLORS_PER_CALL), so int32 never wraps.  The sums are
// the Pallas kernel's and the plain version's, which sum per color block.

#include <cstdint>
#include <cuda_runtime.h>

#include "gram_wgmma.cuh"

namespace {

using namespace gram;

// d[64] = A (64x16 bf16, registers) . B (16x128 bf16, shared memory)
//         + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b,
                                                 uint32_t accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

struct Bf16Form {
  using Acc = float;
  static constexpr int kChunk = 64;    // colors per chunk: one 128-byte B row
  static constexpr int kKSteps = kChunk / 16;             // wgmma k16 steps
  static constexpr int kStages = 6;    // packed-input ring depth
  static constexpr int kSideBytes = (kTile / 8) * kChunk;  // bits of one side
  static constexpr int kRowBytes = 2 * kChunk;              // a bf16 row
  // a ring stage: i bits, j bits, two int8 limb rows, the same two limb
  // rows as bf16
  static constexpr int kLimbs = 2 * kSideBytes;
  static constexpr int kLimbsBf16 = kLimbs + 2 * kChunk;
  static constexpr int kStageBytes = kLimbsBf16 + 2 * kRowBytes;
  static constexpr int kPrepAhead = 2;
  static constexpr bool kSegments = true;

  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b,
                                             uint32_t accumulate) {
    wgmma_m64n128k16(d, a, desc_b, accumulate);
  }

  // Unpacks the j side of one stage (16 byte rows x 64 colors) into B: row
  // n = 8r + p holds bit (7 - p) of byte row r as one bf16 per color (1.0
  // or 0), with the 16-byte group c (colors 8c..8c+7) stored at group
  // c ^ (n % 8).  Each thread turns 8 colors of one byte row into 4 of its
  // 8 sample rows: (word >> (7 - p)) & 0x01010101 gives 4 colors' bits as 4
  // bytes, a byte permute spreads two of them into 16-bit halves, and times
  // 0x3F80 makes each a bf16 1.0 or 0.
  static __device__ __forceinline__ void unpack_b(
      const uint8_t* __restrict__ jbits, uint8_t* __restrict__ b) {
    const int u = threadIdx.x % 128;
    const int r = u / 8;           // byte row
    const int grp = u % 8;         // 8-color group
    const int p0 = 4 * (threadIdx.x / 128);
    const uint2 w = *reinterpret_cast<const uint2*>(jbits + r * kChunk + grp * 8);
    #pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
      const int p = p0 + pp;
      const int sh = 7 - p;
      const uint32_t x = (w.x >> sh) & 0x01010101u;
      const uint32_t y = (w.y >> sh) & 0x01010101u;
      uint4 v;
      v.x = __byte_perm(x, 0, 0x4140) * 0x3F80u;
      v.y = __byte_perm(x, 0, 0x4342) * 0x3F80u;
      v.z = __byte_perm(y, 0, 0x4140) * 0x3F80u;
      v.w = __byte_perm(y, 0, 0x4342) * 0x3F80u;
      *reinterpret_cast<uint4*>(b + (8 * r + p) * kRowBytes + ((grp ^ p) * 16)) = v;
    }
  }

  // The stage's G int8 limb rows as bf16 rows, two colors a thread.  An
  // integer <= 127 has at most 7 significant bits, so its float's upper
  // half is its bf16.
  template <int G>
  static __device__ __forceinline__ void prep(uint8_t* stage) {
    const int tid = threadIdx.x;
    if (tid < 32 * G) {
      const int l = tid / 32, c = 2 * (tid % 32);
      const int8_t* src = reinterpret_cast<const int8_t*>(stage + kLimbs)
                          + l * kChunk + c;
      const uint32_t lo = __float_as_uint(static_cast<float>(src[0])) >> 16;
      const uint32_t hi = __float_as_uint(static_cast<float>(src[1])) & 0xFFFF0000u;
      *reinterpret_cast<uint32_t*>(stage + kLimbsBf16 + l * kRowBytes + 2 * c) =
          lo | hi;
    }
  }

  // 0xFFFF in the low half if bit (7 - g) of byte 0 of v is set, in the
  // high half if that of byte 1 is: the bit is shifted to the top of its
  // byte and prmt's selector nibbles 0x8 / 0x9 replicate a byte's top bit.
  static __device__ __forceinline__ uint32_t bit_masks16(uint32_t v, int g) {
    uint32_t m;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(m) : "r"(v << g), "r"(0u), "r"(0x9988u));
    return m;
  }

  // This thread's A fragments of one stage, for each k16 step and limb.  In
  // wgmma's 16-bit A layout a warp holds 16 rows x 16 colors: lane 4g + t
  // has row g in registers 0 and 2, row g + 8 in 1 and 3, colors 2t, 2t + 1
  // in 0 and 1 and 8 + 2t, 9 + 2t in 2 and 3, one bf16 per color (the lower
  // color in the lower half).  Rows g and g + 8 of warp w in warpgroup h
  // are bit (7 - g) of byte rows 8h + 2w and 8h + 2w + 1.
  template <int G>
  static __device__ __forceinline__ void build_a(
      const uint8_t* __restrict__ stage, uint32_t (&a)[kKSteps][G][4]) {
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const uint8_t* row0 = stage + 2 * (threadIdx.x / 32) * kChunk + 2 * t;
    const uint8_t* limbs = stage + kLimbsBf16 + 4 * t;
    #pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
      #pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = 16 * s + 8 * hh;  // this thread's colors: c + 2t, + 1
        const uint32_t m0 = bit_masks16(
            *reinterpret_cast<const uint16_t*>(row0 + c), g);
        const uint32_t m1 = bit_masks16(
            *reinterpret_cast<const uint16_t*>(row0 + kChunk + c), g);
        #pragma unroll
        for (int l = 0; l < G; ++l) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(
              limbs + l * kRowBytes + 2 * c);
          a[s][l][2 * hh] = m0 & w;
          a[s][l][2 * hh + 1] = m1 & w;
        }
      }
    }
  }

  // out[0], out[1] += x, y rounded to int32 (exact: integers below 2^24)
  static __device__ __forceinline__ void add_out(int32_t* p, float x, float y) {
    asm volatile(
        "{\n"
        ".reg .s32 u, v, s, t;\n"
        "cvt.rni.s32.f32 s, %1;\n"
        "cvt.rni.s32.f32 t, %2;\n"
        "ld.global.v2.s32 {u, v}, [%0];\n"
        "add.s32 u, u, s;\n"
        "add.s32 v, v, t;\n"
        "st.global.v2.s32 [%0], {u, v};\n"
        "}\n"
        :: "l"(p), "f"(x), "f"(y) : "memory");
  }
};

// One launch for any L (kPairs: L >= 2).
template <bool kPairs>
__global__ void __launch_bounds__(kThreads, 1)
gram_bf16_wgmma_kernel(const Args a) {
  gram_kernel<Bf16Form, kPairs>(a);
}

}  // namespace

extern "C" {

int ks_gram_chunk_bf16() { return Bf16Form::kChunk; }

// One kernel launch for any L; the f32 sums are flushed into out at least
// every segment_chunks chunks.  Shapes are checked by the Python wrapper;
// returns the first CUDA error, so a refused launch is not silent.
int ks_gram_bf16_tiles(const void* bits_i, const void* bits_j, const void* wl,
                       const void* tile_i, const void* tile_j, void* out,
                       int num_pairs, int n_blocks, int block, int n_limbs,
                       int npad_i, int npad_j, int segment_chunks,
                       void* stream) {
  if (segment_chunks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (num_pairs <= 0 || n_limbs <= 0 || n_blocks <= 0 || block < Bf16Form::kChunk)
    return static_cast<int>(cudaGetLastError());
  const Args a{static_cast<const uint8_t*>(bits_i),
               static_cast<const uint8_t*>(bits_j),
               static_cast<const int8_t*>(wl),
               static_cast<const int32_t*>(tile_i),
               static_cast<const int32_t*>(tile_j),
               static_cast<int32_t*>(out),
               num_pairs, n_blocks, block, n_limbs, npad_i, npad_j,
               segment_chunks};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return n_limbs >= 2
      ? launch<Bf16Form>(gram_bf16_wgmma_kernel<true>, a, st)
      : launch<Bf16Form>(gram_bf16_wgmma_kernel<false>, a, st);
}

}  // extern "C"
