#!/bin/bash
# CPU-scale copy of tools/rank_study_cpu.sh through the PyTorch port's CLIs:
# tools/torch_rank_study.sh at SSRL_RANK_SCALE=cpu (batch 200, 8 epochs on
# 8k unlabeled images, ~300 optimizer steps per model; results in
# $SSRL_RANK_OUT, default outputs/torch_rank_study_cpu). The CLIs run on the
# CPU because SSRL_TORCH_DEVICE=cpu asks them to; nothing falls back to the
# CPU on its own.
export SSRL_RANK_SCALE=cpu SSRL_TORCH_DEVICE=cpu
exec bash "$(dirname "$0")/torch_rank_study.sh" "$@"
