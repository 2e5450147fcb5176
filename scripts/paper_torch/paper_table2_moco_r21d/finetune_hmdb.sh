#!/bin/sh
# port of scripts/paper/paper_table2_moco_r21d/finetune_hmdb.sh
. "$(dirname "$0")/../common.sh"
python -m dualvar_tpu_torch.train.classifier --preset paper_table1_hmdb_ft \
  --prefix paper_table2_moco_r21d --name_prefix "$EXP_NAME" \
  --pretrain "log/paper_table2_moco_r21d/pretrain/$EXP_NAME/model" $DATA_ARGS
