// Tiled block kernel: the block stage of the tile-skipping `tiled_fused`
// route.  One thread block per block of B tiles of one residual group.
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/tiled_scan.py
// (`block_runner` -> `_pallas_eval`, body `_eval_block`), together with the
// XLA decode prologue and output scatter around it, which the reference
// runs as separate gathers and scatters through device memory.  The
// reference adds bits with a carry-free `.at[].add` only because JAX lacks
// an XOR scatter; atomicOr / atomicXor on shared words give the same bits.
//
// What bounds it.  Each residual input cell is read once from its pack and
// each output tile written once; the decoded cells never reach device
// memory.  What is left is the interpreter over the group's program, as in
// the circuit kernel (circuit_eval.cu), with its register file in shared
// memory: three reads and two writes a full adder and word.  On an H100 the
// shared-memory pipe is the SM's busiest unit, so every phase is laid out to
// put few dependent shared-memory round trips on a warp's path:
//
//   (1) the block's cell descriptors and the first STAGED_ROWS rows of its
//       group's program are staged into shared memory once (v2 re-read a
//       descriptor from device memory for every input slot of every word,
//       and staged the program a chunk at a time behind two barriers); the
//       rows of a longer program past those are read from device memory,
//       where every thread of a warp reads the same row;
//   (a) each thread fills the clean words it owns by class, reading the
//       descriptors of four slots before it writes any word;
//   (b) every other cell is decoded by one warp: dense rows by 16-byte
//       cp.async, sparse bits by atomicOr, run endpoints by atomicXor and a
//       warp prefix-XOR (doubling shifts in a word, word parities scanned by
//       shuffles and carried across the tile) -- no barrier between kinds;
//   (c) the group's program, interpreted as the circuit kernel interprets
//       its own (fused full adders, constants in slots);
//   (d) the k_max output rows are stored straight to their tiles.
//
// Not done here, measured: folding the clean inputs through the program per
// warp inside the kernel.  Its serial pass over the program on one warp
// waits on the shared-memory pipe or on the issue of many bit operations:
// a second pass added 0.85 ms to a launch of 1.85 ms with the fold's state
// in shared memory, 1.5 ms with it in registers, while the fold saved
// 0.2-0.3 ms of interpretation (Interval(2,10) on the clustered 1 GiB
// index, H100; PERF.md).  Tensor cores are not used: they do not
// evaluate a gate DAG, and a popcount route through `mma ... b1` would
// compute another algorithm than the circuit the reference runs.
//
// The register file is [n_regs][B * tw] words; a thread owns the words
// tid + v * threads (v < VEC) of every slot, so in (c) and (d) it reads only
// words it wrote itself.  One word a thread (VEC = 1) measured faster than
// two on an H100 (more warps hide the shared-memory latency); VEC = 2 serves
// tiles wider than 1,024 words.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

enum : int {
    OP_AND = 0, OP_OR = 1, OP_XOR = 2, OP_ANDNOT = 3, OP_LOAD = 4, OP_COMMIT = 5, OP_WAIT = 6,
    OP_FA = 7, OP_MAJ = 8, OP_EXT = 9, OP_NOP = 10, OP_CONST = 11
};
enum : int { CELL_ZERO = 0, CELL_ONE = 1, CELL_DENSE = 2, CELL_SPARSE = 3, CELL_RUN = 4 };

constexpr unsigned FULL = 0xFFFFFFFFu;
// program rows staged in shared memory (must equal tiled_scan.STAGED_ROWS)
constexpr int STAGED_ROWS = 256;

// Shared memory of a block, in this order: the block's cell descriptors
// int[m_max][B][3] (16-byte aligned), the first rows of the group's program
// int4[min(n_rows, STAGED_ROWS)], the register file uint32[n_regs][B * tw].
__host__ __device__ inline int staged_rows(int n_rows) {
    return n_rows < STAGED_ROWS ? n_rows : STAGED_ROWS;
}
__host__ __device__ inline size_t cells_bytes(int m_max, int B) {
    return ((size_t)m_max * B * 3 * sizeof(int) + 15) & ~(size_t)15;
}
__host__ __device__ inline size_t shared_bytes(int m_max, int B, int tw, int n_regs, int n_rows) {
    return cells_bytes(m_max, B) + (size_t)staged_rows(n_rows) * 16 + (size_t)n_regs * B * tw * 4;
}

__device__ __forceinline__ void cp_async16(uint32_t* dst_shared, const uint32_t* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst_shared);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t* dst_shared, const uint32_t* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst_shared);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// (b) one non-clean cell into its row of tw words, by one warp
__device__ void decode_cell(uint32_t* row, const int* c, const uint32_t* __restrict__ dense,
                            const uint16_t* __restrict__ sparse,
                            const uint16_t* __restrict__ runs, int tw, bool aligned16) {
    const int lane = threadIdx.x & 31;
    const int kind = c[0];
    if (kind == CELL_DENSE) {
        const uint32_t* src = dense + (long long)c[1] * tw;
        if (aligned16) {
            for (int w = 4 * lane; w < tw; w += 128) cp_async16(row + w, src + w);
        } else {
            for (int w = lane; w < tw; w += 32) cp_async4(row + w, src + w);
        }
        return;
    }
    for (int w = lane; w < tw; w += 32) row[w] = 0;
    __syncwarp();
    if (kind == CELL_SPARSE) {
        for (int p = c[1] + lane; p < c[2]; p += 32) {
            const int pos = sparse[p];
            atomicOr(row + (pos >> 5), 1u << (pos & 31));
        }
        return;
    }
    const int span = tw * 32;
    for (int p = c[1] + lane; p < c[2]; p += 32) {
        const int s = runs[2 * (long long)p], e = runs[2 * (long long)p + 1];
        atomicXor(row + (s >> 5), 1u << (s & 31));
        if (e < span) atomicXor(row + (e >> 5), 1u << (e & 31));  // at the span: off the tile
    }
    __syncwarp();
    // prefix-XOR inside each word, word parities scanned across the warp and
    // carried from one 32-word chunk to the next
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

// (c) rows [0, n) of a group's program, VEC words per thread per instruction,
// as the circuit kernel interprets its own (a thread reads only words it
// wrote itself: no barrier)
template <int VEC>
__device__ __forceinline__ void run_rows(const int4* rows, int n, uint32_t* regs, int bw,
                                         const int (&wv)[VEC], const bool (&own)[VEC]) {
    for (int i = 0; i < n; ++i) {
        const int4 ins = rows[i];
        uint32_t* d = regs + ins.y * bw;
        if (ins.x == OP_FA || ins.x == OP_MAJ) {
            // (op, dst_sum | dst_carry, a, b) (EXT, dst_carry, c, 0)
            const int4 ext = rows[++i];
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

template <int VEC>
__global__ void __launch_bounds__(1024) tiled_block_kernel(
        uint32_t* __restrict__ out, const int* __restrict__ gids, const int* __restrict__ cells,
        const int* __restrict__ dst, const int4* __restrict__ prog, const int4* __restrict__ groups,
        const int* __restrict__ outs, const uint32_t* __restrict__ dense,
        const uint16_t* __restrict__ sparse, const uint16_t* __restrict__ runs, int m_max, int B,
        int tw, int k_max, int n_rows_max) {
    extern __shared__ int4 shared[];
    unsigned char* base = (unsigned char*)shared;
    int* scells = (int*)base;                                       // [m][B][3]
    int4* sprog = (int4*)(base + cells_bytes(m_max, B));            // [staged rows]
    uint32_t* regs = (uint32_t*)(sprog + staged_rows(n_rows_max));  // [n_regs][B * tw]
    const int tid = threadIdx.x;
    const int nthr = blockDim.x;
    const int warp = tid >> 5;
    const int nwarps = nthr >> 5;
    const int bw = B * tw;
    const long long blk = blockIdx.x;
    const int g = gids[blk];
    const int4 grp = groups[g];  // (offset, length, n_registers, n_inputs)
    const int m = grp.w;
    const int n_instr = grp.y;
    const int4* gprog = prog + grp.x;
    const int* go = outs + (long long)g * k_max;

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

    // (1) the block's cell descriptors of its group's m wires, the first rows
    // of its program
    const int* bc = cells + blk * (long long)m_max * B * 3;
    const int n_staged = staged_rows(n_instr);
    for (int i = tid; i < m * B * 3; i += nthr) scells[i] = bc[i];
    for (int i = tid; i < n_staged; i += nthr) sprog[i] = gprog[i];
    __syncthreads();

    // (a) clean words, by the thread that owns them, four slots at a time
    // (their descriptors read before any word is written)
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
        if (!own[v]) continue;
        const int* c = scells + tv[v] * 3;
        uint32_t* r = regs + wv[v];
        int s = 0;
        for (; s + 4 <= m; s += 4) {
            const int k0 = c[s * B * 3], k1 = c[(s + 1) * B * 3];
            const int k2 = c[(s + 2) * B * 3], k3 = c[(s + 3) * B * 3];
            if (k0 <= CELL_ONE) r[s * bw] = k0 ? FULL : 0u;
            if (k1 <= CELL_ONE) r[(s + 1) * bw] = k1 ? FULL : 0u;
            if (k2 <= CELL_ONE) r[(s + 2) * bw] = k2 ? FULL : 0u;
            if (k3 <= CELL_ONE) r[(s + 3) * bw] = k3 ? FULL : 0u;
        }
        for (; s < m; ++s) {
            const int k = c[s * B * 3];
            if (k <= CELL_ONE) r[s * bw] = k ? FULL : 0u;
        }
    }
    // (b) every other cell, one warp a cell
    const bool aligned16 = (tw & 3) == 0 && ((uintptr_t)dense & 15) == 0;
    for (int ci = warp; ci < m * B; ci += nwarps) {
        const int* c = scells + ci * 3;
        if (c[0] >= CELL_DENSE)
            decode_cell(regs + (ci / B) * bw + (ci % B) * tw, c, dense, sparse, runs, tw, aligned16);
    }
    cp_async_wait_all();
    __syncthreads();

    // (c) the group's program: the staged rows from shared memory, then any
    // later rows from device memory (a full adder's two rows are not split)
    int n_first = n_staged;
    if (n_first > 0 && n_first < n_instr &&
        (sprog[n_first - 1].x == OP_FA || sprog[n_first - 1].x == OP_MAJ))
        --n_first;
    run_rows<VEC>(sprog, n_first, regs, bw, wv, own);
    run_rows<VEC>(gprog + n_first, n_instr - n_first, regs, bw, wv, own);

    // (d) outputs straight to their tiles
    const int* bd = dst + blk * (long long)k_max * B;
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

// Raises the kernel's dynamic shared-memory ceiling to the card's opt-in
// maximum, once per device (the ceiling is only a limit: each launch still
// takes the size it asks for, and nothing here lowers it again).
template <int VEC>
cudaError_t raise_shared_ceiling() {
    static std::atomic<unsigned long long> raised{0};  // bit d: device d done
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (raised.load(std::memory_order_relaxed) & bit) return cudaSuccess;
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(tiled_block_kernel<VEC>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e == cudaSuccess) raised.fetch_or(bit, std::memory_order_relaxed);
    return e;
}

template <int VEC>
cudaError_t launch(void* out, const void* gids, const void* cells, const void* dst,
                   const void* prog, const void* groups, const void* outs, const void* dense,
                   const void* sparse, const void* runs, int n_blocks, int m_max, int B, int tw,
                   int k_max, int n_rows, int threads, size_t smem, cudaStream_t stream) {
    cudaError_t e = raise_shared_ceiling<VEC>();
    if (e != cudaSuccess) return e;
    tiled_block_kernel<VEC><<<(unsigned)n_blocks, threads, smem, stream>>>(
        (uint32_t*)out, (const int*)gids, (const int*)cells, (const int*)dst, (const int4*)prog,
        (const int4*)groups, (const int*)outs, (const uint32_t*)dense, (const uint16_t*)sparse,
        (const uint16_t*)runs, m_max, B, tw, k_max, n_rows);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the CUDA error code of the launch (0: ok).
// `threads * vec` must cover the block's B * tw words; n_regs and n_rows are
// the largest register file and program of the table's groups.  Never
// synchronises and allocates nothing.
int tiled_block_launch(void* out, const void* gids, const void* cells, const void* dst,
                       const void* prog, const void* groups, const void* outs, const void* dense,
                       const void* sparse, const void* runs, int n_blocks, int m_max, int B,
                       int tw, int k_max, int n_regs, int n_rows, int threads, int vec,
                       void* stream) {
    if (n_blocks <= 0) return (int)cudaSuccess;
    if (threads <= 0 || threads % 32 != 0 || threads > 1024 || threads * vec < B * tw)
        return (int)cudaErrorInvalidValue;
    const size_t smem = shared_bytes(m_max, B, tw, n_regs, n_rows);
    auto s = (cudaStream_t)stream;
    cudaError_t e;
    switch (vec) {
        case 1: e = launch<1>(out, gids, cells, dst, prog, groups, outs, dense, sparse, runs,
                              n_blocks, m_max, B, tw, k_max, n_rows, threads, smem, s);
                break;
        case 2: e = launch<2>(out, gids, cells, dst, prog, groups, outs, dense, sparse, runs,
                              n_blocks, m_max, B, tw, k_max, n_rows, threads, smem, s);
                break;
        default: e = cudaErrorInvalidValue;
    }
    return (int)e;
}

// Dynamic shared memory one launch of this shape takes (bytes); the wrapper
// holds its own count of the same layout against it.
long long tiled_block_shared_bytes(int m_max, int B, int tw, int n_regs, int n_rows) {
    return (long long)shared_bytes(m_max, B, tw, n_regs, n_rows);
}

// Largest dynamic shared memory a block may opt in to on `device` (bytes), or -1.
int tiled_block_max_shared(int device) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
        return -1;
    return v;
}

const char* tiled_block_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
