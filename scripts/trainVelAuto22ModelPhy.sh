#!/usr/bin/env bash
# Reference-compatible launcher: same role as the reference's script
# of the same name, mapped onto the workload registry.
set -e
cd "$(dirname "$0")/.."
python -m physicsbasedfwi2_tpu.engine.train --workload marmousi_acoustic --netG Auto22 "$@"
