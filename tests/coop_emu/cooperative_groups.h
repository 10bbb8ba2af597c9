#pragma once
// cooperative_groups' grid barrier for tests/coop_emu/cuda_runtime.h.
#include "cuda_runtime.h"

namespace cooperative_groups {
struct grid_group {
  void sync() const { emu_grid_sync(); }
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups
