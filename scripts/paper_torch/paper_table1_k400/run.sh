#!/bin/sh
# port of scripts/paper/paper_table1_k400/run.sh: the full chain
set -e
d="$(dirname "$0")"
sh "$d/pretrain.sh"
sh "$d/finetune.sh"
sh "$d/test.sh"
sh "$d/finetune_hmdb.sh"
sh "$d/test_hmdb.sh"
sh "$d/test_retrieval.sh"
