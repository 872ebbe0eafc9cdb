#!/bin/bash
# Synthetic tone-word recipe — the fully self-contained end-to-end proof:
# audio → fbank → CMVN → records → BLSTM-CTC training (newbob outer loop)
# → TLG graph → lattice decode → WER.  Shape mirrors the reference's
# staged recipes (egs/wsj/run_wsj_phn.sh) with every external dependency
# replaced by this framework's native tools.
#
# usage: run.sh [--stage N] [--stop-stage N] [--work DIR] [--max-iter N]
#               [--num-experts N]

set -e
RECIPE_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
REPO="$(cd "$RECIPE_DIR/../.." && pwd)"
SCRIPTS=$REPO/scripts
BIN=$REPO/bin
FSTBIN=${FSTBIN:-$REPO/native/build}
PYTHON=${PYTHON:-python3}

stage=0
stop_stage=99     # run stages in [stage, stop_stage] (Kaldi convention)
work=$RECIPE_DIR/work
max_iter=25
min_iters=25
keep_lr_iters=0
num_experts=0
num_layers=2
num_neurons=64
num_projects=32
learn_rate=0.006
batch_size=8
num_train=80
num_test=12
seed=7
profile=easy      # easy = saturated pipeline proof (~0% WER);
                  # hard = non-saturated accuracy gate (confusable
                  # tones + noise; WER calibrated into a 5-20% band
                  # where regressions are visible — gen_data.py);
                  # capacity = 36-tone / 72-word head-capacity-bound
                  # task for the MoE treatment experiment (pair with
                  # --num-projects 8)
gen_extra=""      # extra gen_data.py flags (e.g. "--freq-step 1.16")
nj=2              # decode/record conversion fan-out
compute_dtype=    # set to bfloat16 or float32 to pin the matmul operand
                  # precision (the accelerator default is bfloat16)
train_driver=script   # script = scripts/train_oplr.sh (one process per
                      # epoch, the reference protocol); inproc =
                      # bin/nnet-train-loop.py (same state machine in
                      # one process — for per-process-overhead-bound
                      # environments; equivalence pinned by
                      # tests/test_train_loop_inproc.py)

. "$SCRIPTS/parse_options.sh" || exit 1

mkdir -p "$work"

if [ "$stage" -le 0 ] && [ "$stop_stage" -ge 0 ]; then
  echo "===== stage 0: data generation ====="
  hard_flag=""
  [ "$profile" = "hard" ] && hard_flag="--hard"
  [ "$profile" = "capacity" ] && hard_flag="--capacity"
  # shellcheck disable=SC2086
  $PYTHON "$RECIPE_DIR/local/gen_data.py" "$work" "$num_train" 12 \
    "$num_test" 7 $hard_flag $gen_extra
  $PYTHON "$BIN/train-lm.py" --order 2 "$work/data/train/text" \
    > "$work/data/lm.arpa"
fi

if [ "$stage" -le 1 ] && [ "$stop_stage" -ge 1 ]; then
  echo "===== stage 1: TLG graph ====="
  [ ! -x "$FSTBIN/fst-tools" ] && \
    echo "build native tools first: cmake -B native/build -G Ninja native && ninja -C native/build" && exit 1
  bash "$SCRIPTS/make_TLG.sh" "$work/data/dict" "$work/data/lm.arpa" \
    "$work/lang"
fi

if [ "$stage" -le 2 ] && [ "$stop_stage" -ge 2 ]; then
  echo "===== stage 2: fbank + CMVN ====="
  for set in train dev test; do
    dset=$work/data/$set
    $PYTHON "$BIN/compute-fbank-feats.py" --num-mel-bins=40 --dither=0.5 \
      --seed=7 "scp:$dset/wav.scp" \
      "ark,scp:$dset/fbank.ark,$dset/feats.scp"
    $PYTHON "$BIN/compute-cmvn-stats.py" --spk2utt="ark:$dset/spk2utt" \
      "scp:$dset/feats.scp" "ark,scp:$dset/cmvn.ark,$dset/cmvn.scp"
    # single-matrix global stats for the conversion pipe
    $PYTHON "$BIN/compute-cmvn-stats.py" "scp:$dset/feats.scp" \
      "$dset/cmvn.mat"
  done
fi

if [ "$stage" -le 3 ] && [ "$stop_stage" -ge 3 ]; then
  echo "===== stage 3: labels + records ====="
  for set in train dev; do
    dset=$work/data/$set
    # CTC labels: unit ids shifted down by 1 (blank becomes the last
    # network output), reference run_wsj_phn.sh:129-139
    $PYTHON "$BIN/prep-ctc-trans.py" "$work/data/dict/lexicon_numbers.txt" \
        "$dset/text" "<UNK>" |
      awk -v s=1 '{printf $1 " "; for(i=2;i<=NF;i++) printf($i-s)" "; print ""}' |
      $PYTHON "$BIN/copy-int-vector.py" ark:- \
        "ark,scp:$dset/label.ark,$dset/label.scp"
    bash "$SCRIPTS/tfrecord.sh" --feats-scp "$dset/feats.scp" \
      --trans-scp "$dset/label.scp" --cmvn-ark "$dset/cmvn.mat" \
      --nj 2 --dir "$work/records/$set"
  done
  # label counts for the class prior: unshifted ids with explicit blanks
  # interleaved (reference run_wsj_phn.sh:198-207)
  mkdir -p "$work/exp"
  $PYTHON "$BIN/prep-ctc-trans.py" "$work/data/dict/lexicon_numbers.txt" \
      "$work/data/train/text" "<UNK>" |
    awk '{line=$0; gsub(" "," 0 ",line); print line " 0";}' |
    $PYTHON "$BIN/analyze-counts.py" ark:- "$work/exp/label.counts"
fi

# derive the unit count AFTER stage 0 materialized the dict (a stale
# fallback literal here would silently mis-size the output layer if the
# generator's phone set ever changes)
num_units=$(wc -l < "$work/data/dict/units.txt")
num_targets=$((num_units + 1))

if [ "$stage" -le 4 ] && [ "$stop_stage" -ge 4 ]; then
  echo "===== stage 4: training ====="
  cat > "$work/nnet.config" <<EOF
nnet_type = blstm
input_dim = 40
left_context = 0
right_context = 0
subsample = 0
num_layers = $num_layers
num_neurons = $num_neurons
num_projects = $num_projects
num_targets = $num_targets
use_peepholes = true
dropout_rate = 1.0
num_experts = $num_experts
moe_temp = 10.0
seed = $seed
EOF
  [ -n "$compute_dtype" ] && \
    echo "compute_dtype = $compute_dtype" >> "$work/nnet.config"
  if [ "$train_driver" = "inproc" ]; then
    $PYTHON "$BIN/nnet-train-loop.py" \
      --tr-tfrecords-scp "$work/records/train/tfrecords.scp" \
      --cv-tfrecords-scp "$work/records/dev/tfrecords.scp" \
      --nnet-config "$work/nnet.config" --dir "$work/exp" \
      --objective ctc --optimizer adam --learn-rate "$learn_rate" \
      --max-iter "$max_iter" --min-iters "$min_iters" \
      --keep-lr-iters "$keep_lr_iters" \
      --batch-size "$batch_size" --cv-goal loss --shuffle true
  else
    bash "$SCRIPTS/train_oplr.sh" \
      --tr-tfrecords-scp "$work/records/train/tfrecords.scp" \
      --cv-tfrecords-scp "$work/records/dev/tfrecords.scp" \
      --nnet-config "$work/nnet.config" --dir "$work/exp" \
      --objective ctc --optimizer adam --learn-rate "$learn_rate" \
      --max-iter "$max_iter" --min-iters "$min_iters" \
      --keep-lr-iters "$keep_lr_iters" \
      --batch-size "$batch_size" --cv-goal loss --shuffle true
  fi
  # feature-prep markers read by decode_ctc_lat.sh
  echo true > "$work/exp/norm_vars"
  echo false > "$work/exp/add_deltas"
  echo false > "$work/exp/subsample_feats"
  echo false > "$work/exp/splice_feats"
fi

if [ "$stage" -le 5 ] && [ "$stop_stage" -ge 5 ]; then
  echo "===== stage 5: lattice decode + WER ====="
  bash "$SCRIPTS/decode_ctc_lat.sh" --nj "$nj" --beam 16.0 \
    --lattice_beam 8.0 --max-active 5000 --acwt 0.9 \
    --ntargets "$num_targets" --skip-scoring true \
    "$work/lang" "$work/data/test" "$work/exp/decode_test"
  bash "$SCRIPTS/score.sh" --min-acwt 5 --max-acwt 15 \
    "$work/data/test" "$work/lang" "$work/exp/decode_test"
  echo "===== best WER ====="
  grep -H "^summary" "$work/exp/decode_test"/wer_* |
    awk -F'wer: ' '{print $1 $2}' | sort -t' ' -k2 -n | head -1
fi

if [ "$stage" -le 6 ] && [ "$stop_stage" -ge 6 ]; then
  echo "===== stage 6: LM rescoring (second LM over the same lattices) ====="
  # rescore with a bigger KN 3-gram trained on train+dev text — both the
  # on-demand G.fst path (lmrescore.sh) and the mmap const-arpa path
  # (lmrescore_const_arpa.sh, the reference tglarge/fglarge protocol)
  cat "$work/data/train/text" "$work/data/dev/text" |
    $PYTHON "$BIN/train-lm.py" --order 3 - > "$work/data/lm2.arpa"
  bash "$SCRIPTS/make_TLG.sh" "$work/data/dict" "$work/data/lm2.arpa" \
    "$work/lang2" > /dev/null
  bash "$SCRIPTS/lmrescore.sh" --min-acwt 5 --max-acwt 15 \
    "$work/lang" "$work/lang2" "$work/data/test" \
    "$work/exp/decode_test" "$work/exp/decode_test_rescored"
  echo "===== rescored best WER ====="
  grep -H "^summary" "$work/exp/decode_test_rescored"/wer_* |
    awk -F'wer: ' '{print $1 $2}' | sort -t' ' -k2 -n | head -1

  bash "$SCRIPTS/build_const_arpa_lm.sh" "$work/data/lm2.arpa" \
    "$work/lang2" "$work/lang2_carpa"
  bash "$SCRIPTS/lmrescore_const_arpa.sh" --min-acwt 5 --max-acwt 15 \
    "$work/lang" "$work/lang2_carpa" "$work/data/test" \
    "$work/exp/decode_test" "$work/exp/decode_test_carpa"
  echo "===== const-arpa rescored best WER ====="
  grep -H "^summary" "$work/exp/decode_test_carpa"/wer_* |
    awk -F'wer: ' '{print $1 $2}' | sort -t' ' -k2 -n | head -1
fi

echo "run.sh: done"
