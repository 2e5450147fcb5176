#!/bin/sh
# port of scripts/paper/paper_table2_moco_r21d/run.sh: the full chain
set -e
d="$(dirname "$0")"
sh "$d/pretrain.sh"
sh "$d/finetune.sh"
sh "$d/test.sh"
sh "$d/finetune_hmdb.sh"
sh "$d/test_hmdb.sh"
sh "$d/test_retrieval.sh"
