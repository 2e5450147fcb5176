#!/bin/sh
# port of scripts/paper/paper_table1_k400/test_hmdb.sh
. "$(dirname "$0")/../common.sh"
python -m dualvar_tpu_torch.train.classifier --preset paper_table1_hmdb_ft \
  --prefix paper_table1_k400 --name_prefix "$EXP_NAME" \
  --test temporal_ten_clip --resume "log/paper_table1_k400/ft/$EXP_NAME/hmdb/model" $DATA_ARGS
