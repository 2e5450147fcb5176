# Shared launcher bits for the port's paper experiment scripts.
# Port of scripts/paper/common.sh: the same presets (they live in
# dualvar_tpu_torch/core/config.py), flags and log layout, run through
# dualvar_tpu_torch.train.*; chain pretrain -> finetune -> test -> retrieval.
# DATA_ROOT: dir with ClassInd.txt + split CSVs; DB_PATH: frame JPEG root.
#
# The only differences from scripts/paper/, each the repair of a fault of
# the JAX chains:
# (a) this file ends with status 0 whether or not DATA_ROOT / DB_PATH are
#     set (`if` blocks; scripts/paper/common.sh ends on an `&&` list, so
#     under `set -e` every script stops, silently, without DB_PATH);
# (b) EXP_NAME is one name for every stage of a chain: the caller's
#     exported EXP_NAME, else `exp`, the trainers' own name_prefix default
#     (scripts/paper/ defaults it to each script's basename, so each stage
#     reads a directory no other stage wrote);
# (c) every classifier stage passes --prefix <chain> --name_prefix
#     "$EXP_NAME", so its directory is log/<chain>/ft/$EXP_NAME/<ucf|hmdb>,
#     the one the chain's test stages read (the finetune presets' prefix is
#     paper_table1_k400 whatever the chain).
set -e
REPO="$(cd "$(dirname "$0")/../../.." && pwd)"
cd "$REPO"
EXP_NAME="${EXP_NAME:-exp}"
DATA_ARGS=""
if [ -n "$DATA_ROOT" ]; then
  DATA_ARGS="$DATA_ARGS --data_root $DATA_ROOT"
fi
if [ -n "$DB_PATH" ]; then
  DATA_ARGS="$DATA_ARGS --db_path $DB_PATH"
fi
