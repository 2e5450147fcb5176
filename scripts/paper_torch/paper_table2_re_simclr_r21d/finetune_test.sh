#!/bin/sh
# port of scripts/paper/paper_table2_re_simclr_r21d/finetune_test.sh: finetune then test
set -e
d="$(dirname "$0")"
sh "$d/finetune.sh"
sh "$d/test.sh"
