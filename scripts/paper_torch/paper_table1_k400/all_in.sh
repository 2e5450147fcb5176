#!/bin/sh
# port of scripts/paper/paper_table1_k400/all_in.sh: the full chain (alias of run)
exec sh "$(dirname "$0")/run.sh"
