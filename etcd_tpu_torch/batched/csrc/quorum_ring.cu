// Hopper kernels for the batched multi-Raft round: the joint quorum and
// the ring-term lookup. Built with nvcc for sm_90a into a shared
// library with a plain C interface (see hopper_kernels.py, which loads
// it with ctypes, checks every argument and counts launches).
//
// quorum_commit_vote replaces the Pallas kernel of the same name,
// etcd_tpu/batched/pallas_kernels.py (quorum_commit_vote, body
// _quorum_kernel / _committed_block / _vote_block). term_at_batch
// replaces etcd_tpu/batched/pallas_kernels.py (term_at_batch, body
// _term_kernel).
//
// Bound: bytes. Each kernel reads a few bytes per replica slot or query
// and writes one int32 per row; its work is integer compares and counts
// (O(R^2) per row for the quorum, R = 3 on the main path), with no
// product, so the tensor cores have no part here and the 32-bit ALUs
// are far from their limit. At the main path's N = 196,608 rows a call
// moves 1-6 MB: one to a few microseconds of HBM time, close to the
// launch's own cost. The design therefore aims at touching each byte
// once in full sectors and at issuing few instructions per row:
//
// quorum_commit_vote: one thread per tally row, R a template parameter
// for R in {1, 3, 5, 7} (any other R < 128 takes a runtime-R kernel
// with runtime loops). Each thread loads its row's match or votes and
// its instance's voter masks and in_joint once, straight from device
// memory into registers, packs the masks into bitmasks and runs the
// unrolled O(R^2) support loop there. B tallies per instance (votes
// [N*B, R], masks [N, R]) read the masks of instance row / B, so the
// heartbeat-ack prefixes need no mask copies.
//
// The rows are not staged through shared memory. Three builds of this
// kernel were timed against each other on an H100 with
// etcd_tpu_torch/tools/kernel_times.py (PERF.md): the block's
// spans staged by 16-byte cp.async copies, the same spans staged by
// TMA bulk copies on an mbarrier, and no staging. The two staged forms
// were within a few percent of each other; no staging took 21-43% less
// time warm at every main-path form. At N = 196,608 rows all blocks fit
// in one wave, so the kernel is latency-bound: a stage adds a copy, a
// wait and a block barrier to every block's critical path, while a
// warp's R strided 4-byte loads of its 32 rows already fall in the same
// few L1 lines.
//
// term_at_batch: K in {1, 3, 4, 12} and W = 32 at compile time (other K
// and W take a general kernel). The ring slot of a power-of-two W is a
// mask; indexes are 32-bit (the wrapper refuses N*max(K, W) >= 2^31),
// so there is no 64-bit division. Where K is a multiple of 4 and the
// pointers are 16-byte aligned, each thread answers one 16-byte vector
// of 4 queries and loads its instance's bounds once (K = 4: a thread
// per instance; K = 12: three); otherwise one thread answers an
// instance's K queries. The ring is read by direct gathers through L1:
// a build that staged each block's ring tile by a TMA bulk copy was
// slower at every K warm (same measurement), since a block then copies
// 32 KB of ring to read 1-12 words a row. At K = 12 three threads per
// row trade warm time for cold: 15.9 against 12.4 us warm, 21.1 against
// 32.5 us L2-cold (PERF.md), as a warp's gathers then fall on about 11
// rows' ring lines rather than 32; the round's state is larger than L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kMaxI32 = 2147483647;
constexpr int32_t kVotePending = 1;
constexpr int32_t kVoteLost = 2;
constexpr int32_t kVoteWon = 3;

// Mode bits of the quorum launch: most round sites need one half.
constexpr int kModeCommit = 1;
constexpr int kModeVote = 2;

// Threads per block in both kernels.
constexpr int kRows = 256;

unsigned blocks_for(int64_t threads) {
  return static_cast<unsigned>((threads + kRows - 1) / kRows);
}

// -- B1: joint quorum ------------------------------------------------------------

struct QuorumArgs {
  int mode;
  const int32_t* match;     // [rows, r], mode & kModeCommit
  const uint8_t* voter;     // [rows / tallies, r]
  const uint8_t* voter_out; // [rows / tallies, r]
  const uint8_t* in_joint;  // [rows / tallies]
  const int32_t* votes;     // [rows, r], mode & kModeVote
  int32_t* commit;          // [rows]
  int32_t* vres;            // [rows]
  int rows, tallies, r;
};

// Largest masked match value supported by >= n/2+1 voters (the quorum
// support form of raft/quorum/majority.go committed_index); MAX_I32 for
// an empty config.
template <int R>
__device__ __forceinline__ int32_t committed(const int32_t (&match)[R],
                                             uint32_t mask) {
  const int n = __popc(mask);
  if (n == 0) return kMaxI32;
  const int q = n / 2 + 1;
  int32_t best = 0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int32_t c = (mask >> j) & 1 ? match[j] : 0;
    int support = 0;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      support += static_cast<int>((mask >> k) & 1) & (match[k] >= c);
    }
    if (support >= q && c > best) best = c;
  }
  return best;
}

// WON / PENDING / LOST of one half (raft/quorum/majority.go vote_result).
__device__ __forceinline__ int32_t vote_of(int n, int yes, int no) {
  const int q = n / 2 + 1;
  if (yes >= q || n == 0) return kVoteWon;
  if (yes + (n - yes - no) >= q) return kVotePending;
  return kVoteLost;
}

template <int R>
__device__ __forceinline__ int32_t vote(const int32_t (&votes)[R],
                                        uint32_t mask) {
  int yes = 0, no = 0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int in = static_cast<int>((mask >> j) & 1);
    yes += in & (votes[j] == 1);
    no += in & (votes[j] == 0);
  }
  return vote_of(__popc(mask), yes, no);
}

// Lost if either half lost, pending if either is pending, else won
// (raft/quorum/joint.go vote_result); b is WON outside a joint config.
__device__ __forceinline__ int32_t joint_vote(int32_t a, int32_t b) {
  if (a == kVoteLost || b == kVoteLost) return kVoteLost;
  if (a == kVotePending || b == kVotePending) return kVotePending;
  return kVoteWon;
}

template <int R>
__global__ void __launch_bounds__(kRows)
    quorum_commit_vote_kernel(QuorumArgs a) {
  const int t = blockIdx.x * kRows + threadIdx.x;
  if (t >= a.rows) return;
  const int i = t / a.tallies;
  uint32_t in_mask = 0, out_mask = 0;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    in_mask |= static_cast<uint32_t>(a.voter[i * R + k] != 0) << k;
    out_mask |= static_cast<uint32_t>(a.voter_out[i * R + k] != 0) << k;
  }
  const bool joint = a.in_joint[i] != 0;
  if (a.mode & kModeCommit) {
    int32_t m[R];
#pragma unroll
    for (int k = 0; k < R; ++k) m[k] = a.match[t * R + k];
    int32_t c = committed<R>(m, in_mask);
    if (joint) c = min(c, committed<R>(m, out_mask));
    a.commit[t] = c;
  }
  if (a.mode & kModeVote) {
    int32_t v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = a.votes[t * R + k];
    a.vres[t] = joint_vote(vote<R>(v, in_mask),
                           joint ? vote<R>(v, out_mask) : kVoteWon);
  }
}

// Any other R (up to 127): the same functions over device memory, with
// runtime loops.
__device__ int32_t committed_any(const int32_t* match, const uint8_t* mask,
                                 int r) {
  int n = 0;
  for (int j = 0; j < r; ++j) n += mask[j] != 0;
  if (n == 0) return kMaxI32;
  const int q = n / 2 + 1;
  int32_t best = 0;
  for (int j = 0; j < r; ++j) {
    const int32_t c = mask[j] ? match[j] : 0;
    int support = 0;
    for (int k = 0; k < r; ++k) support += (mask[k] != 0) & (match[k] >= c);
    if (support >= q && c > best) best = c;
  }
  return best;
}

__device__ int32_t vote_any(const int32_t* votes, const uint8_t* mask,
                            int r) {
  int n = 0, yes = 0, no = 0;
  for (int j = 0; j < r; ++j) {
    const int in = mask[j] != 0;
    n += in;
    yes += in & (votes[j] == 1);
    no += in & (votes[j] == 0);
  }
  return vote_of(n, yes, no);
}

__global__ void __launch_bounds__(kRows)
    quorum_commit_vote_any_r_kernel(QuorumArgs a) {
  const int t = blockIdx.x * kRows + threadIdx.x;
  if (t >= a.rows) return;
  const int r = a.r;
  const int i = t / a.tallies;
  const bool joint = a.in_joint[i] != 0;
  const uint8_t* in_mask = a.voter + i * r;
  const uint8_t* out_mask = a.voter_out + i * r;
  if (a.mode & kModeCommit) {
    const int32_t* m = a.match + t * r;
    int32_t c = committed_any(m, in_mask, r);
    if (joint) c = min(c, committed_any(m, out_mask, r));
    a.commit[t] = c;
  }
  if (a.mode & kModeVote) {
    const int32_t* v = a.votes + t * r;
    a.vres[t] = joint_vote(vote_any(v, in_mask, r),
                           joint ? vote_any(v, out_mask, r) : kVoteWon);
  }
}

// -- B2: ring-term lookup --------------------------------------------------------

struct TermArgs {
  const int32_t* log_term;    // [n, w]
  const int32_t* snap_index;  // [n]
  const int32_t* snap_term;   // [n]
  const int32_t* last;        // [n]
  const int32_t* idx;         // [n, k]
  int32_t* out;               // [n, k]
  int n, k, w;
};

// snap_term at snap_index, the ring slot for snap_index < x <= last,
// else 0 (raft/log.go term()). A negative index inside the ring reads
// slot 0, as the plain form does.
template <int W>
__device__ __forceinline__ int32_t term_of(const int32_t* ring, int32_t x,
                                           int32_t si, int32_t st,
                                           int32_t la, int w) {
  if (x == si) return st;
  if (x <= si || x > la) return 0;
  if (x < 0) return ring[0];
  return ring[W > 0 ? (x & (W - 1)) : x % w];
}

// K, W > 0: compile-time widths (W a power of two); 0: the general
// kernel. kVec: thread t answers the 4 queries of the t-th 16-byte
// vector of idx, so K/4 threads share a row; else one thread answers a
// row's K queries.
template <int K, int W, bool kVec>
__global__ void __launch_bounds__(kRows) term_at_batch_kernel(TermArgs a) {
  constexpr int kThreadsPerRow = kVec ? K / 4 : 1;
  const int t = blockIdx.x * kRows + threadIdx.x;
  const int i = t / kThreadsPerRow;
  if (i >= a.n) return;
  const int k = K > 0 ? K : a.k;
  const int w = W > 0 ? W : a.w;
  const int32_t* ring = a.log_term + i * w;
  const int32_t si = a.snap_index[i];
  const int32_t st = a.snap_term[i];
  const int32_t la = a.last[i];
  if constexpr (kVec) {
    static_assert(K % 4 == 0, "16-byte vectors need K % 4 == 0");
    const int4 x = reinterpret_cast<const int4*>(a.idx)[t];
    reinterpret_cast<int4*>(a.out)[t] = make_int4(
        term_of<W>(ring, x.x, si, st, la, w),
        term_of<W>(ring, x.y, si, st, la, w),
        term_of<W>(ring, x.z, si, st, la, w),
        term_of<W>(ring, x.w, si, st, la, w));
  } else {
    const int32_t* q = a.idx + i * k;
    int32_t* out = a.out + i * k;
    for (int c = 0; c < k; ++c) out[c] = term_of<W>(ring, q[c], si, st, la, w);
  }
}

template <int K>
void launch_term(const TermArgs& a, bool vec, cudaStream_t s) {
  if constexpr (K % 4 == 0) {
    if (vec) {
      term_at_batch_kernel<K, 32, true>
          <<<blocks_for(int64_t{a.n} * (K / 4)), kRows, 0, s>>>(a);
      return;
    }
  }
  term_at_batch_kernel<K, 32, false><<<blocks_for(a.n), kRows, 0, s>>>(a);
}

}  // namespace

extern "C" {

// mode: 1 = commit index only (votes/vres may be null), 2 = vote result
// only (match/commit may be null), 3 = both. rows = N * tallies; the
// masks and in_joint have N rows. rows * r < 2^31 (the wrapper checks).
cudaError_t quorum_commit_vote_launch(int mode, const void* match,
                                      const void* voter,
                                      const void* voter_out,
                                      const void* in_joint,
                                      const void* votes, void* commit,
                                      void* vres, int rows, int tallies,
                                      int r, void* stream) {
  if (rows == 0) return cudaSuccess;
  const QuorumArgs a{mode,
                     static_cast<const int32_t*>(match),
                     static_cast<const uint8_t*>(voter),
                     static_cast<const uint8_t*>(voter_out),
                     static_cast<const uint8_t*>(in_joint),
                     static_cast<const int32_t*>(votes),
                     static_cast<int32_t*>(commit),
                     static_cast<int32_t*>(vres),
                     rows, tallies, r};
  const unsigned blocks = blocks_for(rows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 1: quorum_commit_vote_kernel<1><<<blocks, kRows, 0, s>>>(a); break;
    case 3: quorum_commit_vote_kernel<3><<<blocks, kRows, 0, s>>>(a); break;
    case 5: quorum_commit_vote_kernel<5><<<blocks, kRows, 0, s>>>(a); break;
    case 7: quorum_commit_vote_kernel<7><<<blocks, kRows, 0, s>>>(a); break;
    default: quorum_commit_vote_any_r_kernel<<<blocks, kRows, 0, s>>>(a);
  }
  return cudaGetLastError();
}

// idx/out are [n, k]; n * max(k, w) < 2^31 (the wrapper checks).
cudaError_t term_at_batch_launch(const void* log_term,
                                 const void* snap_index,
                                 const void* snap_term, const void* last,
                                 const void* idx, void* out, int n, int k,
                                 int w, void* stream) {
  if (n == 0 || k == 0) return cudaSuccess;
  const TermArgs a{static_cast<const int32_t*>(log_term),
                   static_cast<const int32_t*>(snap_index),
                   static_cast<const int32_t*>(snap_term),
                   static_cast<const int32_t*>(last),
                   static_cast<const int32_t*>(idx),
                   static_cast<int32_t*>(out), n, k, w};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec =
      ((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  if (w == 32) {
    switch (k) {
      case 1: launch_term<1>(a, vec, s); return cudaGetLastError();
      case 3: launch_term<3>(a, vec, s); return cudaGetLastError();
      case 4: launch_term<4>(a, vec, s); return cudaGetLastError();
      case 12: launch_term<12>(a, vec, s); return cudaGetLastError();
      default: break;
    }
  }
  term_at_batch_kernel<0, 0, false><<<blocks_for(n), kRows, 0, s>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
