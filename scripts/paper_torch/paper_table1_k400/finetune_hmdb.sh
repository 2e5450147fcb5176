#!/bin/sh
# port of scripts/paper/paper_table1_k400/finetune_hmdb.sh
. "$(dirname "$0")/../common.sh"
python -m dualvar_tpu_torch.train.classifier --preset paper_table1_hmdb_ft \
  --prefix paper_table1_k400 --name_prefix "$EXP_NAME" \
  --pretrain "log/paper_table1_k400/pretrain/$EXP_NAME/model" $DATA_ARGS
