// Weighted Gram tiles from packed membership bits on tensor cores, in an
// int8 form and a bf16 form.
//
// Replaces the four Pallas kernels of kspider_tpu/ops/pallas_pairwise.py:
// cooccurrence_pallas (full square), cooccurrence_pallas_rect (two panels),
// cooccurrence_pallas_tri (explicit upper-triangle tile list) and
// cooccurrence_pallas_sym (upper strips, mirrored afterwards), each in both
// of its compute_dtype forms.  All four compute, over a set of output tiles,
//
//   out[l, i, j] += sum_c bit_i[c, i] * w_l[c] * bit_j[c, j]
//
// and here they are one kernel driven by a tile-pair list: every launch mode
// (all tiles of a rectangle, upper tiles of one panel) is just a list.
//
// Layout (the JAX package's transposed one, colors contiguous):
//   bits   u8[NB, n_pad/8, block]  byte r of color c holds samples 8r..8r+7,
//                                  most significant bit first
//   w      i8[NB, L, block]        base-128 weight limbs, each in [0, 127]
//   out   i32[L, npad_i, npad_j]   accumulated in place (zeroed by the caller)
//
// Design: grid = (tile pairs, limbs); one CTA of 8 warps owns one 128x128
// output tile of one limb and sweeps every color, one chunk of colors at a
// time.  Per chunk each thread loads 32-bit words of packed bits per side
// (coalesced, colors contiguous) and unpacks them with shifts straight into
// shared memory as K-major 0/1 operands (the j side multiplied by its limb,
// which is exact in both forms because limbs are <= 127).  Warps then run
// wmma m16n16k16 products; each warp owns a 32x64 block of the tile (8
// accumulator fragments).  The next chunk's global words are loaded into
// registers before the products, so the loads overlap the math.
//
// The two forms (template parameter Form):
//   int8: s8 x s8 -> s32 products straight into the int32 accumulators,
//         128-color chunks.
//   bf16: bf16 x bf16 -> f32 products, the form of the Pallas kernels with
//         compute_dtype=bfloat16: f32 partial sums inside one color block,
//         each block's sum added into the int32 accumulators.  64-color
//         chunks keep both bf16 operand buffers (2 x 16.5 KB) and the flush
//         staging (8 KB) under the 48 KB static shared-memory limit.  wmma's
//         accumulator element layout is opaque and not promised equal for
//         float and int fragments, so a flush goes through shared memory:
//         store the f32 fragment, convert it in place to int32, load it as
//         an int fragment (the same type as the accumulator, hence the same
//         layout) and add element by element.
//
// Bound: at the dense engine's shapes (K of ~10^5 colors, 1 KB of packed
// bits per color per side) each packed byte feeds 8 x 128 x 2 MACs, far
// above the card's ops:byte ratio, so the kernel is bound by tensor-core
// issue, not by memory.  What this simple design gives up: wgmma and TMA
// (mma.sync-class wmma reaches a fraction of Hopper's peak), a multi-stage
// shared-memory ring (one buffer, two barriers per chunk), persistence,
// reuse of one unpacked chunk across limbs (each limb is its own CTA and
// unpacks again), and skipping the lower half of diagonal tiles.
//
// Exactness: a limb term is at most 127 per color and the caller bounds the
// colors per accumulation (_MAX_COLORS_PER_CALL), so int32 never wraps.  In
// the bf16 form every product is an integer <= 127, and a block's f32 sum
// stays below 2^24 (the caller refuses blocks above 2^24 / 127 colors), so
// it is exact in any summation order.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kTile = 128;         // output tile edge (samples)
constexpr int kThreads = 256;      // 8 warps
constexpr int kWarps = kThreads / 32;

// Operand form: element type, partial-sum type, colors per chunk, and how a
// 32-bit word of packed bits (4 colors of 8 samples) becomes operands.
struct Int8Form {
  using Elem = signed char;
  using Part = int;
  static constexpr int kChunk = 128;
  static constexpr bool kFlush = false;  // products go straight into int32
};

struct Bf16Form {
  using Elem = __nv_bfloat16;
  using Part = float;
  static constexpr int kChunk = 64;
  static constexpr bool kFlush = true;   // f32 per block, then into int32
};

template <typename Form>
struct Geometry {
  using Elem = typename Form::Elem;
  static constexpr int kChunk = Form::kChunk;
  static constexpr int kK16 = kChunk / 16;  // wmma k-steps per chunk
  // one 16-color panel of an operand: kTile rows x 16 elements, padded by 32
  // bytes so unpack stores spread over the banks and every panel stays
  // 32-byte aligned for wmma::load_matrix_sync
  static constexpr int kPanel = kTile * 16 + 32 / sizeof(Elem);
  static constexpr int kWordsPerSide = (kTile / 8) * kChunk / 4;
  static constexpr int kWordsPerThread = kWordsPerSide / kThreads;
  static_assert(kWordsPerThread * kThreads == kWordsPerSide, "chunk split");
};

template <typename Form>
__device__ __forceinline__ void load_chunk(
    const uint32_t* __restrict__ bi, const uint32_t* __restrict__ bj,
    const uint32_t* __restrict__ wl, long long bits_stride_words,
    uint32_t (&ri)[Geometry<Form>::kWordsPerThread],
    uint32_t (&rj)[Geometry<Form>::kWordsPerThread],
    uint32_t (&rw)[Geometry<Form>::kWordsPerThread]) {
  constexpr int kWordsPerRow = Form::kChunk / 4;
  #pragma unroll
  for (int s = 0; s < Geometry<Form>::kWordsPerThread; ++s) {
    const int q = threadIdx.x + s * kThreads;
    const int r = q / kWordsPerRow;   // byte row: samples 8r..8r+7
    const int kw = q % kWordsPerRow;  // word along colors
    ri[s] = __ldg(bi + r * bits_stride_words + kw);
    rj[s] = __ldg(bj + r * bits_stride_words + kw);
    rw[s] = __ldg(wl + kw);
  }
}

// Sample row p of a word: 4 colors, one byte each.  int8: the 4 operand
// bytes as one word.  bf16: 4 bf16 values as two words.
__device__ __forceinline__ void store_row(signed char* dst, uint32_t a) {
  *reinterpret_cast<uint32_t*>(dst) = a;
}

__device__ __forceinline__ uint32_t bf16_pair(uint32_t lo, uint32_t hi) {
  return lo | (hi << 16);
}

template <typename Form>
__device__ __forceinline__ void unpack_chunk(
    typename Form::Elem* __restrict__ sa, typename Form::Elem* __restrict__ sb,
    const uint32_t (&ri)[Geometry<Form>::kWordsPerThread],
    const uint32_t (&rj)[Geometry<Form>::kWordsPerThread],
    const uint32_t (&rw)[Geometry<Form>::kWordsPerThread]) {
  using G = Geometry<Form>;
  constexpr int kWordsPerRow = Form::kChunk / 4;
  #pragma unroll
  for (int s = 0; s < G::kWordsPerThread; ++s) {
    const int q = threadIdx.x + s * kThreads;
    const int r = q / kWordsPerRow;
    const int kw = q % kWordsPerRow;
    const int k = 4 * kw;                       // first of 4 colors
    const int off = (k / 16) * G::kPanel + (k % 16);
    if constexpr (Form::kFlush) {
      // the 4 limbs as bf16 bit patterns; integers <= 127 are exact in bf16
      uint32_t wb[4];
      #pragma unroll
      for (int c = 0; c < 4; ++c)
        wb[c] = __bfloat16_as_ushort(
            __float2bfloat16_rn(static_cast<float>((rw[s] >> (8 * c)) & 0xFFu)));
      constexpr uint32_t kOne = 0x3F80u;  // bf16 1.0
      #pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int row = 8 * r + p;
        const uint32_t a = ri[s] >> (7 - p);
        const uint32_t b = rj[s] >> (7 - p);
        uint32_t av[4], bv[4];
        #pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t abit = (a >> (8 * c)) & 1u;
          const uint32_t bbit = (b >> (8 * c)) & 1u;
          av[c] = abit * kOne;
          bv[c] = bbit * wb[c];
        }
        *reinterpret_cast<uint2*>(sa + off + row * 16) =
            make_uint2(bf16_pair(av[0], av[1]), bf16_pair(av[2], av[3]));
        *reinterpret_cast<uint2*>(sb + off + row * 16) =
            make_uint2(bf16_pair(bv[0], bv[1]), bf16_pair(bv[2], bv[3]));
      }
    } else {
      #pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int row = 8 * r + p;
        // bit (7 - p) of each of the 4 bytes, moved to bit 0 of its byte
        const uint32_t a = (ri[s] >> (7 - p)) & 0x01010101u;
        const uint32_t b = (rj[s] >> (7 - p)) & 0x01010101u;
        store_row(sa + off + row * 16, a);
        store_row(sb + off + row * 16, (b * 0xFFu) & rw[s]);
      }
    }
  }
}

// One chunk of products into this warp's 2 x 4 fragments.
template <typename Form, typename Acc>
__device__ __forceinline__ void mma_chunk(
    const typename Form::Elem* __restrict__ sa,
    const typename Form::Elem* __restrict__ sb, int wm, int wn,
    wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> (&acc)[2][4]) {
  using G = Geometry<Form>;
  using Elem = typename Form::Elem;
  #pragma unroll
  for (int kk = 0; kk < G::kK16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, Elem, wmma::row_major> fa[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, Elem, wmma::col_major> fb[4];
    const Elem* pa = sa + kk * G::kPanel;
    const Elem* pb = sb + kk * G::kPanel;
    #pragma unroll
    for (int m = 0; m < 2; ++m)
      wmma::load_matrix_sync(fa[m], pa + (wm * 32 + m * 16) * 16, 16);
    #pragma unroll
    for (int n = 0; n < 4; ++n)
      wmma::load_matrix_sync(fb[n], pb + (wn * 64 + n * 16) * 16, 16);
    #pragma unroll
    for (int m = 0; m < 2; ++m)
      #pragma unroll
      for (int n = 0; n < 4; ++n)
        wmma::mma_sync(acc[m][n], fa[m], fb[n], acc[m][n]);
  }
}

// Adds one block's f32 partial sums into the int32 accumulators and zeroes
// them, through this warp's 16x16 staging square in shared memory.
__device__ __forceinline__ void flush_block(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&part)[2][4],
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> (&acc)[2][4],
    float* __restrict__ stage) {
  const int lane = threadIdx.x % 32;
  #pragma unroll
  for (int m = 0; m < 2; ++m)
    #pragma unroll
    for (int n = 0; n < 4; ++n) {
      wmma::store_matrix_sync(stage, part[m][n], 16, wmma::mem_row_major);
      __syncwarp();
      // in place: the int32 bit pattern written through the float pointer,
      // so the load and the store of one element are never reordered
      for (int e = lane; e < 256; e += 32)
        stage[e] = __int_as_float(__float2int_rn(stage[e]));  // exact: < 2^24
      __syncwarp();
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> t;
      wmma::load_matrix_sync(t, reinterpret_cast<const int*>(stage), 16,
                             wmma::mem_row_major);
      #pragma unroll
      for (int i = 0; i < t.num_elements; ++i) acc[m][n].x[i] += t.x[i];
      wmma::fill_fragment(part[m][n], 0.0f);
      __syncwarp();  // the next store reuses the staging square
    }
}

template <typename Form>
__global__ void __launch_bounds__(kThreads)
gram_tiles_kernel(const uint8_t* __restrict__ bits_i,
                  const uint8_t* __restrict__ bits_j,
                  const int8_t* __restrict__ wl,
                  const int32_t* __restrict__ tile_i,
                  const int32_t* __restrict__ tile_j,
                  int32_t* __restrict__ out,
                  int n_blocks, int block, int n_limbs,
                  int n8_i, int n8_j, int npad_i, int npad_j) {
  using G = Geometry<Form>;
  using Elem = typename Form::Elem;
  constexpr int kChunk = Form::kChunk;
  __shared__ __align__(128) Elem sa[G::kK16 * G::kPanel];
  __shared__ __align__(128) Elem sb[G::kK16 * G::kPanel];
  // per-warp 16x16 f32 staging for the bf16 flush (unused by int8)
  __shared__ __align__(128) float stage[Form::kFlush ? kWarps * 256 : 8];

  const int pair = blockIdx.x;
  const int limb = blockIdx.y;
  const int ti = tile_i[pair];
  const int tj = tile_j[pair];
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2;  // 4 warps down: rows wm*32 .. +32
  const int wn = warp % 2;  // 2 warps across: cols wn*64 .. +64

  int32_t* out_tile = out + (long long)limb * npad_i * npad_j
                      + (long long)(ti * kTile) * npad_j + tj * kTile;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][4];
  #pragma unroll
  for (int m = 0; m < 2; ++m)
    #pragma unroll
    for (int n = 0; n < 4; ++n)
      wmma::load_matrix_sync(
          acc[m][n], out_tile + (long long)(wm * 32 + m * 16) * npad_j
                         + wn * 64 + n * 16,
          npad_j, wmma::mem_row_major);
  wmma::fragment<wmma::accumulator, 16, 16, 16, typename Form::Part> part[2][4];
  if constexpr (Form::kFlush) {
    #pragma unroll
    for (int m = 0; m < 2; ++m)
      #pragma unroll
      for (int n = 0; n < 4; ++n) wmma::fill_fragment(part[m][n], 0.0f);
  }

  const int chunks_per_block = block / kChunk;
  const int n_chunks = n_blocks * chunks_per_block;
  // 32-bit word strides of the packed layouts
  const long long bw = block / 4;
  auto side_ptr = [&](const uint8_t* bits, int n8, int t, int chunk) {
    const int b = chunk / chunks_per_block;
    const int c0 = (chunk % chunks_per_block) * kChunk;
    return reinterpret_cast<const uint32_t*>(bits)
           + ((long long)b * n8 + t * (kTile / 8)) * bw + c0 / 4;
  };
  auto limb_ptr = [&](int chunk) {
    const int b = chunk / chunks_per_block;
    const int c0 = (chunk % chunks_per_block) * kChunk;
    return reinterpret_cast<const uint32_t*>(wl)
           + ((long long)b * n_limbs + limb) * bw + c0 / 4;
  };

  uint32_t ri[G::kWordsPerThread], rj[G::kWordsPerThread],
      rw[G::kWordsPerThread];
  if (n_chunks > 0)
    load_chunk<Form>(side_ptr(bits_i, n8_i, ti, 0),
                     side_ptr(bits_j, n8_j, tj, 0), limb_ptr(0), bw, ri, rj,
                     rw);

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    __syncthreads();  // previous chunk's products are done with smem
    unpack_chunk<Form>(sa, sb, ri, rj, rw);
    __syncthreads();
    if (chunk + 1 < n_chunks)
      load_chunk<Form>(side_ptr(bits_i, n8_i, ti, chunk + 1),
                       side_ptr(bits_j, n8_j, tj, chunk + 1),
                       limb_ptr(chunk + 1), bw, ri, rj, rw);
    if constexpr (Form::kFlush) {
      mma_chunk<Form>(sa, sb, wm, wn, part);
      if ((chunk + 1) % chunks_per_block == 0)  // the block's last chunk
        flush_block(part, acc, stage + warp * 256);
    } else {
      mma_chunk<Form>(sa, sb, wm, wn, acc);
    }
  }

  #pragma unroll
  for (int m = 0; m < 2; ++m)
    #pragma unroll
    for (int n = 0; n < 4; ++n)
      wmma::store_matrix_sync(
          out_tile + (long long)(wm * 32 + m * 16) * npad_j + wn * 64 + n * 16,
          acc[m][n], npad_j, wmma::mem_row_major);
}

template <typename Form>
int launch(const void* bits_i, const void* bits_j, const void* wl,
           const void* tile_i, const void* tile_j, void* out, int num_pairs,
           int n_blocks, int block, int n_limbs, int npad_i, int npad_j,
           void* stream) {
  if (num_pairs > 0 && n_limbs > 0) {
    gram_tiles_kernel<Form><<<dim3(num_pairs, n_limbs), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bits_i), static_cast<const uint8_t*>(bits_j),
        static_cast<const int8_t*>(wl), static_cast<const int32_t*>(tile_i),
        static_cast<const int32_t*>(tile_j), static_cast<int32_t*>(out),
        n_blocks, block, n_limbs, npad_i / 8, npad_j / 8, npad_i, npad_j);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ks_gram_tile() { return kTile; }
int ks_gram_chunk() { return Int8Form::kChunk; }
int ks_gram_chunk_bf16() { return Bf16Form::kChunk; }

// Each launches one CTA per (tile pair, limb).  Shapes are checked by the
// Python wrapper; returns cudaGetLastError() so a refused launch is not
// silent.
int ks_gram_int8_tiles(const void* bits_i, const void* bits_j, const void* wl,
                       const void* tile_i, const void* tile_j, void* out,
                       int num_pairs, int n_blocks, int block, int n_limbs,
                       int npad_i, int npad_j, void* stream) {
  return launch<Int8Form>(bits_i, bits_j, wl, tile_i, tile_j, out, num_pairs,
                          n_blocks, block, n_limbs, npad_i, npad_j, stream);
}

int ks_gram_bf16_tiles(const void* bits_i, const void* bits_j, const void* wl,
                       const void* tile_i, const void* tile_j, void* out,
                       int num_pairs, int n_blocks, int block, int n_limbs,
                       int npad_i, int npad_j, void* stream) {
  return launch<Bf16Form>(bits_i, bits_j, wl, tile_i, tile_j, out, num_pairs,
                          n_blocks, block, n_limbs, npad_i, npad_j, stream);
}

}  // extern "C"
