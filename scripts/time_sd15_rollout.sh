#!/bin/bash
# The SD1.x rollout (chip_smoke.sd15_slice: a 20-step CFG-DDIM rollout at
# full SD1.5 width, its gradient and the small fp32 check) of two
# checkouts in turns on one card: PARENT, this one, this one, PARENT. Each
# run builds its checkout's kernels and prints the rollout's wall ms,
# device-busy ms and busy share; TF32 off, as chip_smoke.py sets it.
#
#     bash scripts/time_sd15_rollout.sh PARENT_DIR
#
# PARENT_DIR: a checkout holding chip_smoke.py and the port's package, e.g.
# `git archive <commit> | tar -x -C archive_check/parent_full`.
run() {
  (cd "$1" && python3 -c "
import json, torch, chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from pairwise_sample_optimization_tpu_torch.ops import kernel_lib
kernel_lib.build()
s, _ = cs.sd15_slice(0, cs.ShapeRecorder())
print('SD15', '$2', json.dumps({k: s[k] for k in ('rollout_ms', 'device_busy_ms', 'busy_share')}))
" 2>&1 | grep -E "^SD15|Error|error" )
}
here=$(cd "$(dirname "$0")/.." && pwd)
run "$1" parent1
run "$here" change1
run "$here" change2
run "$1" parent2
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
