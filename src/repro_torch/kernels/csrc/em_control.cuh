// The control kernels of the compiled tick and of the modes' program: small
// one-block kernels that steer a program's conditional nodes from the lane
// block's words (em_boundary.cuh), so a served pool's tick, and a solve of
// the modes static and faithful, run as one CUDA graph with no host read
// inside.
//
// Replaces: the host loops of the port's drivers, the counterparts of the
// reference's lax.while_loop conditions: src/repro/core/pmrf/em.py ::
// run_em_ticked (the micro-step while_loop and its partial-tick exit) and
// run_em / run_em_batched in the modes (the MAP loop's condition).  There is
// no Pallas kernel for them.
//
// What bounds them on an H100: launch latency.  Each reads and writes a few
// words per lane (at most 8 B lanes x 4 bytes), nanoseconds of HBM time;
// inside a graph a launch costs a few microseconds of the device's own time.
//
// Design: one block of kThreads threads loops over the B lanes; a block-wide
// OR (__syncthreads_or) gives "some lane" and thread 0 writes the program's
// words and sets the conditional handles.  The tick program:
//
//   tick_init -> WHILE(loop) { step -> tick_stops -> IF(stop) { [M-step] ->
//                                em_boundary_kernel } -> tick_tail } -> tick_publish
//
//   * tick_init: each lane's EM counters and status from the host's mapped
//     in-words (the TickState lists, written before the launch), the
//     tick's words and the program's counters zeroed, `tick_iters` from the in-words, every active lane
//     marked as running the next step (kRunning), the loop's condition:
//     tick_iters > 0 and some lane active.
//   * tick_stops (after the step): a lane that ran the step stops its MAP
//     loop when its flag word is set or its MAP counter is at the cap (the
//     host's rule in the host-stepped tick); kRunning is left set for those
//     lanes alone, the boundary's "ran the EM iteration" word.  The IF
//     node's condition: some lane stopped.
//   * em_boundary_kernel (em_boundary.cuh, its lane form, no handle of its
//     own) runs those lanes' EM boundaries, each at its own EM iteration,
//     and starts the next EM iteration of the lanes that go on.
//   * tick_tail: one more micro-step taken; every active lane runs the next
//     one; the loop's condition: steps < tick_iters and some lane active
//     (the reference's partial-tick exit).
//   * tick_publish (after the loop): each lane's counters, MAP counter and
//     active word, the steps taken and the launches the kernels counted of
//     themselves (the step's, the boundary's, the control kernels' and a
//     mode's segment_reduce launches), into the host's mapped out-words:
//     one wait, one read.
//
// Every control kernel counts its own launches on the device (thread 0):
// tick_init, tick_stops and tick_publish each in a word of their own,
// tick_tail in the steps word, map_ctl in the program's kTickLaunches.
//
// The modes' program is the solve's (program_init -> WHILE(em) { WHILE(map) {
// step } -> M-step -> em_boundary_kernel }) with map_ctl after the captured
// step: the MAP loop's condition from the lanes still active, and the
// step's count.

#pragma once

#include <cuda_runtime.h>

#include "em_boundary.cuh"

namespace em_control {

using em_program::kActive;
using em_program::kEmIters;
using em_program::kFlag;
using em_program::kMapI;
using em_program::kMapIters;
using em_program::kRunning;
using em_program::kStatus;

constexpr int kThreads = 256;

// Words of a tick ((kTickWords,) int32).
enum TickWord : int {
  kSteps = 0,   // micro-steps taken in this tick: tick_tail's own count
  kIters = 1,   // the tick's size (tick_iters)
  kStops = 2,   // micro-steps in which some lane stopped: the IF body's runs (M-steps, boundaries)
  // words 3 and 4: the plain version's WHILE and IF conditions (here handles)
  kInitRuns = 5,     // launches of tick_init, tick_stops and tick_publish, each counted by the
  kStopRuns = 6,     // kernel itself and set back to 0 by tick_publish once it has written
  kPublishRuns = 7,  // them out
  kTickWords = 8,
};

// Host words: in (1 + 3 B): tick_iters, then each lane's em_iters, map_iters
// and status; out (5 B + kTickOut): each lane's em_iters, map_iters, status,
// MAP counter and active word, then the steps, the step's launches, the
// boundary's launches, the IF body's runs, the launches of tick_init,
// tick_stops and tick_publish, and the segment_reduce launches by variant.
constexpr int kOutPerLane = 5;
constexpr int kTickOut = 10;

struct TickCtlPlan {
  int* lane;               // (kLaneWords, B): the pool's lane block
  int* ctl;                // (kCtlWords,): the boundary's words and the launch counters
  int* tick;               // (kTickWords,)
  const int* in_host;      // device view of the mapped in-words, or null (the modes' program)
  int* out_host;           // device view of the mapped out-words
  unsigned long long loop_cond;  // the WHILE node's handle
  unsigned long long stop_cond;  // the IF node's handle
  int batch;
  int max_map_iters;
  int conditional;         // 1: the handles are live (in a graph)
};

__device__ __forceinline__ int* row(const TickCtlPlan& p, int w) { return p.lane + w * p.batch; }

__global__ void __launch_bounds__(kThreads) tick_init(const TickCtlPlan p) {
  const int B = p.batch;
  int any = 0;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    row(p, kEmIters)[b] = p.in_host[1 + b];
    row(p, kMapIters)[b] = p.in_host[1 + B + b];
    row(p, kStatus)[b] = p.in_host[1 + 2 * B + b];
    const int act = row(p, kActive)[b] != 0;
    row(p, kRunning)[b] = act;
    any |= act;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x != 0) return;
  const int iters = p.in_host[0];
  p.tick[kSteps] = 0;
  p.tick[kIters] = iters;
  p.tick[kStops] = 0;
  p.tick[kInitRuns] += 1;
  for (int w = em_program::kTicket; w < em_program::kCtlWords; ++w) p.ctl[w] = 0;
  if (p.conditional) cudaGraphSetConditional(p.loop_cond, (iters > 0 && any) ? 1u : 0u);
}

__global__ void __launch_bounds__(kThreads) tick_stops(const TickCtlPlan p) {
  int any = 0;
  for (int b = threadIdx.x; b < p.batch; b += blockDim.x) {
    const int stop = row(p, kRunning)[b] != 0 &&
                     (row(p, kFlag)[b] != 0 || row(p, kMapI)[b] == p.max_map_iters);
    row(p, kRunning)[b] = stop;
    any |= stop;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x != 0) return;
  p.tick[kStopRuns] += 1;
  if (any) p.tick[kStops] += 1;
  if (p.conditional) cudaGraphSetConditional(p.stop_cond, any ? 1u : 0u);
}

__global__ void __launch_bounds__(kThreads) tick_tail(const TickCtlPlan p) {
  int any = 0;
  for (int b = threadIdx.x; b < p.batch; b += blockDim.x) {
    const int act = row(p, kActive)[b] != 0;
    row(p, kRunning)[b] = act;
    any |= act;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x != 0) return;
  const int steps = p.tick[kSteps] + 1;
  p.tick[kSteps] = steps;
  if (p.conditional) cudaGraphSetConditional(p.loop_cond, (steps < p.tick[kIters] && any) ? 1u : 0u);
}

__global__ void __launch_bounds__(kThreads) tick_publish(const TickCtlPlan p) {
  const int B = p.batch;
  volatile int* out = p.out_host;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    out[kOutPerLane * b + 0] = row(p, kEmIters)[b];
    out[kOutPerLane * b + 1] = row(p, kMapIters)[b];
    out[kOutPerLane * b + 2] = row(p, kStatus)[b];
    out[kOutPerLane * b + 3] = row(p, kMapI)[b];
    out[kOutPerLane * b + 4] = row(p, kActive)[b];
  }
  if (threadIdx.x != 0) return;
  p.tick[kPublishRuns] += 1;
  volatile int* words = out + kOutPerLane * B;
  words[0] = p.tick[kSteps];
  words[1] = p.ctl[em_program::kTickLaunches];
  words[2] = p.ctl[em_program::kBoundaryLaunches];
  words[3] = p.tick[kStops];
  for (int j = 0; j < 3; ++j) words[4 + j] = p.tick[kInitRuns + j];
  for (int j = 0; j < 3; ++j) words[7 + j] = p.ctl[em_program::kSegAdd + j];
  p.tick[kInitRuns] = p.tick[kStopRuns] = p.tick[kPublishRuns] = 0;
}

// The modes' MAP loop, after each captured step: the step's count (the
// program's kTickLaunches word: the flat steps), and the loop's condition
// (some lane still active: the step cleared the active word of each lane
// that stopped).
__global__ void __launch_bounds__(kThreads) map_ctl(const TickCtlPlan p) {
  int any = 0;
  for (int b = threadIdx.x; b < p.batch; b += blockDim.x) any |= row(p, kActive)[b] != 0;
  any = __syncthreads_or(any);
  if (threadIdx.x != 0) return;
  p.ctl[em_program::kTickLaunches] += 1;
  if (p.conditional) cudaGraphSetConditional(p.loop_cond, any ? 1u : 0u);
}

}  // namespace em_control
