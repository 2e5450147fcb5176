#!/bin/sh
# port of scripts/paper/paper_table1_k400/finetune_test.sh: finetune then test
set -e
d="$(dirname "$0")"
sh "$d/finetune.sh"
sh "$d/test.sh"
