#!/usr/bin/env bash
# One-command real-data run of the PyTorch port (the counterpart of
# scripts/real_data.sh): processed QM9S .pt -> packed store -> train -> eval
# (the reference's headline protocol, ref README.md:104-118), through
# python -m diffspectra_tpu_torch.main.
#
# Prerequisites: the reference's processed dataset under
#   $DATA_ROOT/processed/data_qm9_allspectra.pt        (required)
#   $DATA_ROOT/split_dict_diffspectra_qm9.pt           (the conditional split;
#                                                       optional, a seeded
#                                                       split otherwise)
# or the at-scale stand-in that
#   python -m diffspectra_tpu_torch.tools.make_rehearsal_pt --root $DATA_ROOT
# writes. The first run converts the .pt into the dense packed store
# ($DATA_ROOT/packed/*.npy, diffspectra_tpu_torch/data/qm9s.py:pack_from_pyg);
# later runs memory-map the packed arrays.
#
# WORKDIR: the train workdir (default exp/qm9s_real). SPECTRA:
# data.spectra_version (default allspectra). DATA_ROOT: where the processed
# and packed dataset lives (default data/QM9S). EVAL_CKPT: the numbered
# checkpoint to evaluate (the reference's protocol: 40). TRAIN_FLAGS /
# EVAL_FLAGS: more arguments of each command (--config KEY=VALUE, --device
# cpu), after the script's own, whose keys they override. PYTHON: the
# interpreter (default python). Runs on cuda unless the flags hold --device
# cpu; stops at the first command that fails.
set -e
ROOT=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
PYTHON=${PYTHON:-python}
WORKDIR=${WORKDIR:-exp/qm9s_real}
SPECTRA=${SPECTRA:-allspectra}
DATA_ROOT=${DATA_ROOT:-data/QM9S}
EVAL_CKPT=${EVAL_CKPT:-40}

# 1. train (the reference's budget: 2M steps of batch 128 a device; under
#    torchrun the batch sizes scale with the world size)
"$PYTHON" -m diffspectra_tpu_torch.main --mode train --workdir "$WORKDIR" \
    --config data.synthetic=false --config data.spectra_version="$SPECTRA" \
    --config data.root="$DATA_ROOT" ${TRAIN_FLAGS:-}

# 2. the full evaluation of the reference's checkpoint (10k molecules, 1000
#    ancestral steps, every metric with Top-K structure recovery)
"$PYTHON" -m diffspectra_tpu_torch.main --mode eval --workdir "$WORKDIR" \
    --config data.synthetic=false --config data.spectra_version="$SPECTRA" \
    --config data.root="$DATA_ROOT" \
    --config eval.ckpts="$EVAL_CKPT" --config eval.num_candidates=10 ${EVAL_FLAGS:-}
