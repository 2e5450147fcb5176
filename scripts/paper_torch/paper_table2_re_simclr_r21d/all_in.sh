#!/bin/sh
# port of scripts/paper/paper_table2_re_simclr_r21d/all_in.sh: the full chain (alias of run)
exec sh "$(dirname "$0")/run.sh"
