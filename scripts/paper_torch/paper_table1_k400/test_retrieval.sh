#!/bin/sh
# port of scripts/paper/paper_table1_k400/test_retrieval.sh (k-NN retrieval, ds=4)
. "$(dirname "$0")/../common.sh"
python -m dualvar_tpu_torch.train.classifier --preset paper_table1_ucf_ft \
  --prefix paper_table1_k400 --name_prefix "$EXP_NAME" \
  --test retrieval --pretrain "log/paper_table1_k400/pretrain/$EXP_NAME/model" $DATA_ARGS
