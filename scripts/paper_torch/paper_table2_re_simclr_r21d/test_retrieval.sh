#!/bin/sh
# port of scripts/paper/paper_table2_re_simclr_r21d/test_retrieval.sh (k-NN retrieval, ds=4)
. "$(dirname "$0")/../common.sh"
python -m dualvar_tpu_torch.train.classifier --preset paper_table1_ucf_ft \
  --prefix paper_table2_re_simclr_r21d --name_prefix "$EXP_NAME" \
  --test retrieval --pretrain "log/paper_table2_re_simclr_r21d/pretrain/$EXP_NAME/model" $DATA_ARGS
