// The update phase's per-iteration layout and its merge replay, over state
// that stays on the card for the whole phase.
//
// The state: per row its cluster slot assign[r] and its position seq[r] in
// that cluster's member list; per slot s the center row cen[s], alive[s]
// and the member count clen[s].  Slots are the clusters at the phase's
// start, in the engine's order; a merge kills a slot and never makes one,
// so the alive slots in ascending order are the engine's cluster list.
//
// phase_layout (mc2_phase_layout), one cooperative launch:
//   1. rank[s] = alive slots before s; inv[rank] = s; C = alive slots;
//      moff[k] = the members of ranks < k (moff[C] = n);
//   2. the flat member table flat[moff[rank[assign[r]]] + seq[r]] = r (a
//      scatter: every row lands at its cluster's offset plus its position,
//      so cluster k's members are flat[moff[k] .. moff[k + 1]) in order);
//   3-5. every (center rank j, member row) pair of j's +/-delta
//      neighbourhood, the one contiguous slice flat[moff[j - delta] ..
//      moff[j + delta + 1]) (ranks clamped to [0, C)), cut by the length
//      window lens[r] in [blen[c], elen[c]] of the center row c: a warp a
//      center counts its pairs, block 0 scans the counts, a warp a center
//      writes them in gather order as (a_rows = c, b_rows = r, seg = j), P
//      in all.  hdr = (C, P).
// The gather order is the host engine's (cluster/engine.py:
// _batched_mean_shift_update) and the tie order (2 delta - o, seq) of the
// JAX program's closest-to-mean key (meshclust2_tpu/cluster/
// device_phase.py l. 374-375), so closest_mean's first minimum by position
// is the reference's tie rule.
//
// phase_candidates (mc2_phase_candidates, its own kernel), after the
// iteration's filter and closest-to-mean: each alive slot's new center
// (first[k] < P: the member b_rows[first[k]]; no kept member: the old
// center, or, in the final delta = 0 pass, the cluster's first member
// flat[moff[k]]) into cen_out, and the merge pass's candidate pairs (rank
// i, rank i + q) for q = 1..delta at position i delta + q - 1 as (a = the
// candidate's new center, b = rank i's, seg = i, ok = i + q < C and the
// candidate's length inside rank i's window).  The candidates stay at this
// fixed bound delta C with `ok` as their cut: their window reads the new
// centers, so a count of them could reach the host only by a second read
// in the iteration.
//
// merge_replay (mc2_merge_replay), one cooperative launch: the merge pass's
// absorb events t_dst[s] (the slot s merges into, or -1), applied in
// ascending slot order as the host engine applies them
// (`clusters[ret].members.extend(clusters[i].members)`): the members of s
// get seq += clen[dst] and assign = dst, clen[dst] += clen[s], s dies.
// Every destination lies above its source, so a slot's whole inflow comes
// before its own event.  Block 0 lists the events; one thread walks them
// ascending for the clen bookkeeping (each event's offset) and descending
// for each slot's final slot and total offset; after one grid barrier
// every row moves in parallel.
//
// Replaces the JAX program meshclust2_tpu/cluster/device_phase.py:
// DevicePhaseUpdater._build's `ranks` (l. 218-226) and the row targeting
// of `filter_mean`, `closest` and `merge_pass.q_body` (l. 261-282, 326-352,
// 462-470) (phase_layout), and `rp_body` (l. 519-547, a while-loop over
// absorb events with an O(rows) masked update each) (merge_replay); the
// port's host-driven counterpart built the same pairs in numpy each
// iteration (cluster/engine.py).
//
// What bounds them on an H100: at the 10k bench set's shapes (n = 10,000
// rows, C ~ 800-1,150 clusters, P ~ 90,000-110,000 pairs) they move well
// under 3 MB a call; they are latency-bound: what counts is the number of
// launches, grid barriers (four in the layout, one in the replay) and
// dependent memory round trips (the replay's walk over the events).
//
// Built by nvcc for sm_90a (ops/_build.py) and bound through ctypes: the
// entry points launch on the given stream, allocate nothing, do not
// synchronise and return the launch's error.

#include <algorithm>

#include "coop.cuh"

namespace {

using namespace mc2;

// Exclusive prefix sums of val(i) over [0, m) by one block: sink(i, sum of
// val over [0, i)) for every i, each thread over its own contiguous range;
// returns the total to every thread.  buf holds kWarps values.
template <class Val, class Sink>
__device__ long long block_scan(long long m, Val val, Sink sink, long long* buf) {
  const long long t = threadIdx.x;
  const long long per = (m + kThreads - 1) / kThreads;
  const long long lo = min(m, per * t);
  const long long hi = min(m, lo + per);
  long long own = 0;
  for (long long i = lo; i < hi; ++i) own += val(i);
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int warp = threadIdx.x / kWarpSize;
  long long x = own;  // inclusive scan over the warp
#pragma unroll
  for (int o = 1; o < kWarpSize; o <<= 1) {
    const long long y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();  // buf may still be read from a previous call
  if (lane == kWarpSize - 1) buf[warp] = x;
  __syncthreads();
  long long run = x - own, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) run += buf[w];
    total += buf[w];
  }
  for (long long i = lo; i < hi; ++i) {
    const long long v = val(i);  // before sink, which may overwrite it
    sink(i, run);
    run += v;
  }
  return total;
}

struct LayoutArgs {
  long long n, S;
  int delta;
  const long long* assign;
  const long long* seq;
  const unsigned char* alive;
  const long long* cen;
  const long long* clen;
  const long long* lens;
  const long long* blen;
  const long long* elen;
  long long* rank;
  long long* inv;
  long long* moff;   // [S + 1]
  long long* flat;   // [n]
  long long* a_rows;  // [(2 delta + 1) n]
  long long* b_rows;
  long long* seg;
  long long* cnt;    // [S + 1] scratch: pairs a center, then their offsets
  long long* hdr;    // [2]: C, P
};

// The length-passed members of center rank j's neighbourhood, 32 at a time
// by the calling warp: with WRITE, written as pairs from position pos on in
// gather order; returns their number to every lane.
template <bool WRITE>
__device__ __forceinline__ long long neighbourhood(const LayoutArgs& a, long long j,
                                                   long long C, long long pos) {
  const int lane = threadIdx.x & (kWarpSize - 1);
  const long long c = a.cen[a.inv[j]];
  const long long lo = a.blen[c], hi = a.elen[c];
  const long long x0 = a.moff[max(0LL, j - a.delta)];
  const long long x1 = a.moff[min(C - 1, j + a.delta) + 1];
  long long k = 0;
  for (long long base = x0; base < x1; base += kWarpSize) {
    const long long x = base + lane;
    long long r = -1;
    bool ok = false;
    if (x < x1) {
      r = a.flat[x];
      const long long len = a.lens[r];
      ok = len >= lo && len <= hi;
    }
    const unsigned m = __ballot_sync(kFullMask, ok);
    if (WRITE && ok) {
      const long long p = pos + k + __popc(m & ((1u << lane) - 1u));
      a.a_rows[p] = c;
      a.b_rows[p] = r;
      a.seg[p] = j;
    }
    k += __popc(m);
  }
  return k;
}

__global__ void __launch_bounds__(kThreads) layout_kernel(LayoutArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ long long buf[kWarps];
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * kThreads;
  const long long wid = tid / kWarpSize;
  const long long nwarps = nthreads / kWarpSize;
  const int lane = threadIdx.x & (kWarpSize - 1);

  // 1. ranks, the slot of each rank, the member offsets by rank
  if (blockIdx.x == 0) {
    const unsigned char* alive = a.alive;
    long long* rank = a.rank;
    long long* inv = a.inv;
    const long long C = block_scan(
        a.S, [&](long long s) { return alive[s] ? 1LL : 0LL; },
        [&](long long s, long long r) {
          rank[s] = r;
          if (alive[s]) inv[r] = s;
        },
        buf);
    __syncthreads();  // rank[] complete before the second scan reads it
    const long long* clen = a.clen;
    long long* moff = a.moff;
    const long long rows = block_scan(
        a.S, [&](long long s) { return alive[s] ? clen[s] : 0LL; },
        [&](long long s, long long o) {
          if (alive[s]) moff[rank[s]] = o;
        },
        buf);
    if (threadIdx.x == 0) {
      moff[C] = rows;
      a.hdr[0] = C;
    }
  }
  grid.sync();
  const long long C = a.hdr[0];

  // 2. the flat member table
  for (long long r = tid; r < a.n; r += nthreads) {
    a.flat[a.moff[a.rank[a.assign[r]]] + a.seq[r]] = r;
  }
  grid.sync();

  // 3. pairs a center
  for (long long j = wid; j < C; j += nwarps) {
    const long long k = neighbourhood<false>(a, j, C, 0);
    if (lane == 0) a.cnt[j] = k;
  }
  grid.sync();

  // 4. their offsets
  if (blockIdx.x == 0) {
    long long* cnt = a.cnt;
    const long long P = block_scan(
        C, [&](long long j) { return cnt[j]; },
        [&](long long j, long long o) { cnt[j] = o; }, buf);
    if (threadIdx.x == 0) a.hdr[1] = P;
  }
  grid.sync();

  // 5. the pairs, in gather order
  for (long long j = wid; j < C; j += nwarps) {
    neighbourhood<true>(a, j, C, a.cnt[j]);
  }
}

struct CandArgs {
  long long S, C, P;
  int delta;
  int final_pass;
  const unsigned char* alive;
  const long long* cen;
  const long long* rank;
  const long long* inv;
  const long long* moff;
  const long long* flat;
  const long long* b_rows;
  const long long* first;
  const long long* lens;
  const long long* blen;
  const long long* elen;
  long long* cen_out;  // [S]
  long long* ca;       // [delta C]
  long long* cb;
  long long* cs;
  unsigned char* ok;
};

// The new center of rank k (the kept-empty rules of device_phase.py
// l. 551-555 and 611-622).
__device__ __forceinline__ long long new_center(const CandArgs& a, long long k) {
  const long long f = a.first[k];
  if (f < a.P) return a.b_rows[f];
  return a.final_pass ? a.flat[a.moff[k]] : a.cen[a.inv[k]];
}

__global__ void __launch_bounds__(kThreads) candidates_kernel(CandArgs a) {
  const long long x = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (x < a.S) a.cen_out[x] = a.alive[x] ? new_center(a, a.rank[x]) : a.cen[x];
  if (x < a.delta * a.C) {
    const long long i = x / a.delta;
    const long long j = i + x % a.delta + 1;
    const long long ci = new_center(a, i);
    bool ok = j < a.C;
    const long long cj = ok ? new_center(a, j) : ci;
    ok = ok && a.lens[cj] >= a.blen[ci] && a.lens[cj] <= a.elen[ci];
    a.ca[x] = cj;
    a.cb[x] = ci;
    a.cs[x] = i;
    a.ok[x] = ok ? 1 : 0;
  }
}

struct ReplayArgs {
  long long n, S;
  const long long* assign;
  const long long* seq;
  const unsigned char* alive;
  const long long* clen;
  const long long* t_dst;
  long long* assign_out;
  long long* seq_out;
  unsigned char* alive_out;
  long long* clen_out;
  long long* fin;  // [S] scratch: each slot's final slot
  long long* tot;  // [S] scratch: its event's offset, then its total offset
  long long* ev;   // [S] scratch: the events' slots, ascending
};

__global__ void __launch_bounds__(kThreads) replay_kernel(ReplayArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ long long buf[kWarps];
  if (blockIdx.x == 0) {
    const unsigned char* alive = a.alive;
    const long long* t_dst = a.t_dst;
    const long long* clen = a.clen;
    long long* clen_out = a.clen_out;
    unsigned char* alive_out = a.alive_out;
    long long* fin = a.fin;
    long long* tot = a.tot;
    long long* ev = a.ev;
    const long long E = block_scan(
        a.S, [&](long long s) { return (alive[s] && t_dst[s] >= 0) ? 1LL : 0LL; },
        [&](long long s, long long e) {
          clen_out[s] = clen[s];
          alive_out[s] = alive[s];
          fin[s] = s;
          tot[s] = 0;
          if (alive[s] && t_dst[s] >= 0) ev[e] = s;
        },
        buf);
    __syncthreads();
    if (threadIdx.x == 0) {
      for (long long e = 0; e < E; ++e) {
        const long long s = ev[e], d = t_dst[s];
        tot[s] = clen_out[d];
        clen_out[d] += clen_out[s];
        clen_out[s] = 0;
        alive_out[s] = 0;
      }
      for (long long e = E - 1; e >= 0; --e) {
        const long long s = ev[e], d = t_dst[s];
        fin[s] = fin[d];
        tot[s] += tot[d];
      }
    }
  }
  grid.sync();
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * kThreads;
  for (long long r = tid; r < a.n; r += nthreads) {
    const long long s = a.assign[r];
    a.assign_out[r] = a.fin[s];
    a.seq_out[r] = a.seq[r] + a.tot[s];
  }
}

long long blocks_for(long long items) { return (items + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// scratch: int64 [S + 1]; outputs as LayoutArgs; hdr int64 [2]
int mc2_phase_layout(long long n, long long S, int delta, const void* assign,
                     const void* seq, const void* alive, const void* cen,
                     const void* clen, const void* lens, const void* blen,
                     const void* elen, void* rank, void* inv, void* moff, void* flat,
                     void* a_rows, void* b_rows, void* seg, void* scratch, void* hdr,
                     void* stream) {
  if (n <= 0 || S <= 0 || delta < 0) return static_cast<int>(cudaErrorInvalidValue);
  LayoutArgs a{n,
               S,
               delta,
               static_cast<const long long*>(assign),
               static_cast<const long long*>(seq),
               static_cast<const unsigned char*>(alive),
               static_cast<const long long*>(cen),
               static_cast<const long long*>(clen),
               static_cast<const long long*>(lens),
               static_cast<const long long*>(blen),
               static_cast<const long long*>(elen),
               static_cast<long long*>(rank),
               static_cast<long long*>(inv),
               static_cast<long long*>(moff),
               static_cast<long long*>(flat),
               static_cast<long long*>(a_rows),
               static_cast<long long*>(b_rows),
               static_cast<long long*>(seg),
               static_cast<long long*>(scratch),
               static_cast<long long*>(hdr)};
  void* args[] = {&a};
  // a thread a row, a warp a center
  const long long want = std::max(blocks_for(n), blocks_for(S * kWarpSize));
  return static_cast<int>(coop_launch(reinterpret_cast<const void*>(&layout_kernel),
                                      want, 0, args, static_cast<cudaStream_t>(stream)));
}

// outputs: cen_out int64 [S]; ca, cb, cs int64 and ok uint8 [delta C]
int mc2_phase_candidates(long long S, long long C, long long P, int delta,
                         int final_pass, const void* alive, const void* cen,
                         const void* rank, const void* inv, const void* moff,
                         const void* flat, const void* b_rows, const void* first,
                         const void* lens, const void* blen, const void* elen,
                         void* cen_out, void* ca, void* cb, void* cs, void* ok,
                         void* stream) {
  if (S <= 0 || C < 0 || C > S || P < 0 || delta < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CandArgs a{S,
             C,
             P,
             delta,
             final_pass,
             static_cast<const unsigned char*>(alive),
             static_cast<const long long*>(cen),
             static_cast<const long long*>(rank),
             static_cast<const long long*>(inv),
             static_cast<const long long*>(moff),
             static_cast<const long long*>(flat),
             static_cast<const long long*>(b_rows),
             static_cast<const long long*>(first),
             static_cast<const long long*>(lens),
             static_cast<const long long*>(blen),
             static_cast<const long long*>(elen),
             static_cast<long long*>(cen_out),
             static_cast<long long*>(ca),
             static_cast<long long*>(cb),
             static_cast<long long*>(cs),
             static_cast<unsigned char*>(ok)};
  const long long items = std::max(S, static_cast<long long>(delta) * C);
  candidates_kernel<<<dim3(static_cast<unsigned>(blocks_for(items))), dim3(kThreads), 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// scratch: int64 [3 S]
int mc2_merge_replay(long long n, long long S, const void* assign, const void* seq,
                     const void* alive, const void* clen, const void* t_dst,
                     void* assign_out, void* seq_out, void* alive_out, void* clen_out,
                     void* scratch, void* stream) {
  if (n <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  long long* sc = static_cast<long long*>(scratch);
  ReplayArgs a{n,
               S,
               static_cast<const long long*>(assign),
               static_cast<const long long*>(seq),
               static_cast<const unsigned char*>(alive),
               static_cast<const long long*>(clen),
               static_cast<const long long*>(t_dst),
               static_cast<long long*>(assign_out),
               static_cast<long long*>(seq_out),
               static_cast<unsigned char*>(alive_out),
               static_cast<long long*>(clen_out),
               sc,
               sc + S,
               sc + 2 * S};
  void* args[] = {&a};
  return static_cast<int>(coop_launch(reinterpret_cast<const void*>(&replay_kernel),
                                      blocks_for(n), 0, args,
                                      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
