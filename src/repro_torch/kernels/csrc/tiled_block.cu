// Tiled block kernel: the block stage of the tile-skipping `tiled_fused`
// route.  One thread block per block of B tiles of one residual group:
//   (a) dense cells are copied from the dense pack, clean cells filled by
//       class (all zeros / all ones),
//   (b) sparse cells set one bit per uint16 position (atomicOr),
//   (c) run cells toggle both interval endpoints (atomicXor) and are filled
//       by a prefix-XOR: doubling shifts inside each word, then a warp scan
//       of the word parities carried across the tile,
// all straight into the shared-memory slots the group's program reads;
//   (d) a uniform branch on the block's group id into that group's program
//       in the program table, interpreted as the circuit kernel
//       (circuit_eval.cu) interprets its own: fused full adders, constants
//       in slots, the program staged into shared memory a chunk at a time;
//   (e) the k_max output rows stored straight to their tiles (dst < 0: none).
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/tiled_scan.py
// (`block_runner` -> `_pallas_eval`, body `_eval_block`), together with the
// XLA decode prologue and output scatter around it, which the reference
// runs as separate gathers and scatters through device memory.  The
// reference adds bits with a carry-free `.at[].add` only because JAX lacks
// an XOR scatter; atomicOr / atomicXor on shared words give the same bits.
//
// Work per launch: each residual input cell read once from its pack, each
// output tile written once, the group's gates per word.  The decoded cells
// never reach device memory.  For dense-heavy data that is bound by bytes;
// for the 64-input overflow circuits it is the interpreter's instruction
// issue that bounds it, as it bounds the circuit kernel.
// The register file is [n_regs][B * tw] words; a thread owns the words
// tid + v * threads (v < VEC) of every slot, so in (d) and (e) it reads only
// words it wrote itself.  One word a thread (VEC = 1) measured faster than
// two on an H100 (more warps hide the shared-memory latency); VEC = 2 serves
// tiles wider than 1,024 words.  In (a) each thread fills its own column of
// every input slot and computes its word's tile once, not once per word.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum : int {
    OP_AND = 0, OP_OR = 1, OP_XOR = 2, OP_ANDNOT = 3, OP_LOAD = 4, OP_COMMIT = 5, OP_WAIT = 6,
    OP_FA = 7, OP_MAJ = 8, OP_EXT = 9, OP_NOP = 10, OP_CONST = 11
};
enum : int { CELL_ZERO = 0, CELL_ONE = 1, CELL_DENSE = 2, CELL_SPARSE = 3, CELL_RUN = 4 };

constexpr int PROG_CHUNK = 256;  // must equal core.bytecode.PROG_CHUNK
constexpr unsigned FULL = 0xFFFFFFFFu;

template <int VEC>
__global__ void tiled_block_kernel(uint32_t* __restrict__ out, const int* __restrict__ gids,
                                   const int* __restrict__ cells, const int* __restrict__ dst,
                                   const int4* __restrict__ prog, const int4* __restrict__ groups,
                                   const int* __restrict__ outs, const uint32_t* __restrict__ dense,
                                   const uint16_t* __restrict__ sparse,
                                   const uint16_t* __restrict__ runs, int m_max, int B, int tw,
                                   int k_max) {
    extern __shared__ int4 shared[];
    int4* sprog = shared;                               // [PROG_CHUNK]
    uint32_t* regs = (uint32_t*)(shared + PROG_CHUNK);  // [n_regs][B * tw]
    const int tid = threadIdx.x;
    const int nthr = blockDim.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = nthr >> 5;
    const int bw = B * tw;
    const long long blk = blockIdx.x;
    const int g = gids[blk];
    const int4 grp = groups[g];  // (offset, length, n_registers, n_inputs)
    const int m = grp.w;
    const int* bc = cells + blk * (long long)m_max * B * 3;

    // the words of every slot this thread owns: w = tid + v * threads, word
    // ww of tile t of the block (a thread may own fewer than VEC words)
    int wv[VEC], tv[VEC], wwv[VEC];
    bool own[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
        wv[v] = tid + v * nthr;
        own[v] = wv[v] < bw;
        tv[v] = own[v] ? wv[v] / tw : 0;
        wwv[v] = wv[v] - tv[v] * tw;
    }

    // (a) every owned word of the m input slots: dense copy, class fill, or zero
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
        if (!own[v]) continue;
        const int* c = bc + tv[v] * 3;
        for (int i = 0; i < m; ++i, c += B * 3) {
            const int kind = c[0];
            uint32_t x = 0;
            if (kind == CELL_ONE) x = FULL;
            else if (kind == CELL_DENSE) x = dense[(long long)c[1] * tw + wwv[v]];
            regs[i * bw + wv[v]] = x;
        }
    }
    __syncthreads();

    // (b, c) payload of the compressed cells: one warp per cell
    for (int ci = warp; ci < m * B; ci += nwarps) {
        const int* c = bc + ci * 3;
        const int kind = c[0];
        if (kind != CELL_SPARSE && kind != CELL_RUN) continue;
        uint32_t* row = regs + (ci / B) * bw + (ci % B) * tw;
        if (kind == CELL_SPARSE) {
            for (int p = c[1] + lane; p < c[2]; p += 32) {
                const int pos = sparse[p];
                atomicOr(row + (pos >> 5), 1u << (pos & 31));
            }
        } else {
            const int span = tw * 32;
            for (int p = c[1] + lane; p < c[2]; p += 32) {
                const int s = runs[2 * (long long)p], e = runs[2 * (long long)p + 1];
                atomicXor(row + (s >> 5), 1u << (s & 31));
                if (e < span) atomicXor(row + (e >> 5), 1u << (e & 31));  // at the span: off the tile
            }
        }
    }
    __syncthreads();

    // (c) fill the run cells: prefix-XOR inside each word, word parities
    // scanned across the warp and carried from one 32-word chunk to the next
    for (int ci = warp; ci < m * B; ci += nwarps) {
        if (bc[ci * 3] != CELL_RUN) continue;  // uniform across the warp
        uint32_t* row = regs + (ci / B) * bw + (ci % B) * tw;
        uint32_t carry = 0;
        for (int w0 = 0; w0 < tw; w0 += 32) {
            const int w = w0 + lane;
            uint32_t x = w < tw ? row[w] : 0u;
            x ^= x << 1;
            x ^= x << 2;
            x ^= x << 4;
            x ^= x << 8;
            x ^= x << 16;
            const uint32_t par = x >> 31;
            uint32_t inc = par;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const uint32_t y = __shfl_up_sync(FULL, inc, d);
                if (lane >= d) inc ^= y;
            }
            const uint32_t before = inc ^ par ^ carry;  // parity of every earlier word
            x ^= 0u - before;
            if (w < tw) row[w] = x;
            carry ^= __shfl_sync(FULL, inc, 31);
        }
    }

    // (d) the group's program, VEC words per thread per instruction
    const int4* gprog = prog + grp.x;
    const int n_instr = grp.y;
    for (int c0 = 0; c0 < n_instr; c0 += PROG_CHUNK) {
        const int cnt = min(PROG_CHUNK, n_instr - c0);
        __syncthreads();  // decode done / everyone is done with the previous chunk
        for (int i = tid; i < cnt; i += nthr) sprog[i] = gprog[c0 + i];
        __syncthreads();
        for (int i = 0; i < cnt; ++i) {
            const int4 ins = sprog[i];
            uint32_t* d = regs + ins.y * bw;
            if (ins.x == OP_FA || ins.x == OP_MAJ) {
                // (op, dst_sum | dst_carry, a, b) (EXT, dst_carry, c, 0); never split by a chunk
                const int4 ext = sprog[i + 1];
                ++i;
                const uint32_t* ra = regs + ins.z * bw;
                const uint32_t* rb = regs + ins.w * bw;
                const uint32_t* rc = regs + ext.z * bw;
                uint32_t a[VEC], b[VEC], c[VEC];
#pragma unroll
                for (int v = 0; v < VEC; ++v)
                    if (own[v]) a[v] = ra[wv[v]], b[v] = rb[wv[v]], c[v] = rc[wv[v]];
                uint32_t* dc = (ins.x == OP_FA) ? regs + ext.y * bw : d;
#pragma unroll
                for (int v = 0; v < VEC; ++v) {
                    if (!own[v]) continue;
                    const uint32_t half = a[v] ^ b[v];
                    if (ins.x == OP_FA) d[wv[v]] = half ^ c[v];
                    dc[wv[v]] = (a[v] & b[v]) | (c[v] & half);
                }
            } else if (ins.x <= OP_ANDNOT) {
                const uint32_t* ra = regs + ins.z * bw;
                const uint32_t* rb = regs + ins.w * bw;
                uint32_t a[VEC], b[VEC];
#pragma unroll
                for (int v = 0; v < VEC; ++v)
                    if (own[v]) a[v] = ra[wv[v]], b[v] = rb[wv[v]];
#pragma unroll
                for (int v = 0; v < VEC; ++v) {
                    if (!own[v]) continue;
                    uint32_t r;
                    if (ins.x == OP_AND) r = a[v] & b[v];
                    else if (ins.x == OP_OR) r = a[v] | b[v];
                    else if (ins.x == OP_XOR) r = a[v] ^ b[v];
                    else r = a[v] & ~b[v];
                    d[wv[v]] = r;
                }
            } else if (ins.x == OP_CONST) {
#pragma unroll
                for (int v = 0; v < VEC; ++v)
                    if (own[v]) d[wv[v]] = (uint32_t)ins.z;
            }  // NOP: nothing (the host never puts LOAD / COMMIT / WAIT here)
        }
    }
    __syncthreads();  // a program of no instructions reads the decoded slots directly

    // (e) outputs straight to their tiles
    const int* bd = dst + blk * (long long)k_max * B;
    const int* go = outs + (long long)g * k_max;
    for (int j = 0; j < k_max; ++j) {
        const uint32_t* src = regs + go[j] * bw;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
            if (!own[v]) continue;
            const int d = bd[j * B + tv[v]];
            if (d >= 0) out[(long long)d * tw + wwv[v]] = src[wv[v]];
        }
    }
}

template <int VEC>
cudaError_t launch(void* out, const void* gids, const void* cells, const void* dst,
                   const void* prog, const void* groups, const void* outs, const void* dense,
                   const void* sparse, const void* runs, int n_blocks, int m_max, int B, int tw,
                   int k_max, int threads, size_t smem, cudaStream_t stream) {
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(tiled_block_kernel<VEC>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    tiled_block_kernel<VEC><<<(unsigned)n_blocks, threads, smem, stream>>>(
        (uint32_t*)out, (const int*)gids, (const int*)cells, (const int*)dst, (const int4*)prog,
        (const int4*)groups, (const int*)outs, (const uint32_t*)dense, (const uint16_t*)sparse,
        (const uint16_t*)runs, m_max, B, tw, k_max);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the CUDA error code of the launch (0: ok).
// `threads * vec` must cover the block's B * tw words.  Never synchronises
// and allocates nothing.
int tiled_block_launch(void* out, const void* gids, const void* cells, const void* dst,
                       const void* prog, const void* groups, const void* outs, const void* dense,
                       const void* sparse, const void* runs, int n_blocks, int m_max, int B,
                       int tw, int k_max, int n_regs, int threads, int vec, void* stream) {
    if (n_blocks <= 0) return (int)cudaSuccess;
    if (threads <= 0 || threads % 32 != 0 || threads > 1024 || threads * vec < B * tw)
        return (int)cudaErrorInvalidValue;
    const size_t smem = PROG_CHUNK * sizeof(int4) + (size_t)n_regs * B * tw * sizeof(uint32_t);
    auto s = (cudaStream_t)stream;
    cudaError_t e;
    switch (vec) {
        case 1: e = launch<1>(out, gids, cells, dst, prog, groups, outs, dense, sparse, runs,
                              n_blocks, m_max, B, tw, k_max, threads, smem, s); break;
        case 2: e = launch<2>(out, gids, cells, dst, prog, groups, outs, dense, sparse, runs,
                              n_blocks, m_max, B, tw, k_max, threads, smem, s); break;
        default: e = cudaErrorInvalidValue;
    }
    return (int)e;
}

// Shared memory a block spends on the staged program chunk (bytes).
int tiled_block_program_bytes() { return PROG_CHUNK * (int)sizeof(int4); }

// Largest dynamic shared memory a block may opt in to on `device` (bytes), or -1.
int tiled_block_max_shared(int device) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
        return -1;
    return v;
}

const char* tiled_block_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
