// Stage marks: one empty one-thread kernel per stage of a forward or a
// train step, launched where the stage begins (utils/profiling.mark). A
// mark is an ordinary kernel, so a CUDA graph captures it and every replay
// records it: the device trace shows each stage's start under the mark's
// own name, in order, on the trace's clock. The stages and their order are
// utils/profiling.STAGES; the names hold no substring of a kernel family
// (utils/profiling.KERNEL_FAMILIES), so a mark counts as "elementwise /
// other".

#include <cuda_runtime.h>

#define STAGE_MARKS(X) \
  X(prep)              \
  X(corr)              \
  X(gen)               \
  X(losses)            \
  X(loss_backward)     \
  X(net_backward)      \
  X(g_update)          \
  X(d_step)            \
  X(end)

#define DEFINE_MARK(stage) \
  __global__ void stage_mark_##stage() {}
STAGE_MARKS(DEFINE_MARK)
#undef DEFINE_MARK

namespace {

using Mark = void (*)();

#define LIST_MARK(stage) &stage_mark_##stage,
const Mark kMarks[] = {STAGE_MARKS(LIST_MARK)};
#undef LIST_MARK

constexpr int kStages = sizeof(kMarks) / sizeof(kMarks[0]);

}  // namespace

// Launches stage `stage`'s mark (its index in STAGE_MARKS) on `stream` and
// returns the cudaError_t of the launch.
extern "C" int cocosnet_stage_mark(int stage, void* stream) {
  if (stage < 0 || stage >= kStages)
    return static_cast<int>(cudaErrorInvalidValue);
  kMarks[stage]<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
