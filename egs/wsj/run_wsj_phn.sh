#!/bin/bash
# WSJ phone-CTC recipe — staged pipeline mirroring the reference's
# egs/wsj/run_wsj_phn.sh:76-290 on this framework's native tooling:
#   stage 1: data prep + phone dict + TLG decode graph
#   stage 2: 40-d fbank + per-speaker CMVN
#   stage 3: CTC labels (blank→last shift) + length-sorted records + priors
#   stage 4: nnet.config + newbob training (train_oplr.sh)
#   stage 5: lattice decode of dev93/eval92 + WER sweep
#   stage 6: const-arpa rescore with the unpruned trigram (reference
#            run_wsj_phn.sh:279-286)
#
# Model defaults = the reference treatment config (run_wsj_phn.sh:10-46):
# 4×BLSTM-320 proj 320, 120-d input (40 fbank + Δ + ΔΔ), splice ±1,
# subsample 3, keep-prob 0.9 dropout, adam 1e-3, batch 32, MoE experts 72
# temp 10.
#
# usage: run_wsj_phn.sh --wsj0 <dir> --wsj1 <dir> --cmudict <file> [opts]

set -e
RECIPE_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
REPO="$(cd "$RECIPE_DIR/../.." && pwd)"
SCRIPTS=$REPO/scripts
BIN=$REPO/bin
LOCAL=$RECIPE_DIR/local
PYTHON=${PYTHON:-python3}

stage=1
stop_stage=100
work=$RECIPE_DIR  # output root for data/ and exp/ (default: recipe dir)
wsj0=
wsj1=
cmudict=
lm_arpa=            # pretrained decode ARPA (e.g. WSJ tgpr); empty →
                    # self-train with bin/train-lm.py in stage 1
rescore_arpa=       # larger ARPA for const-arpa rescoring (e.g. tg)
nj=16
seed=777

# acoustic model (reference run_wsj_phn.sh:10-46)
num_layers=4
num_neurons=320
num_projects=320
left_context=1
right_context=1
subsample=3
dropout_rate=0.9
num_experts=72
moe_temp=10
learn_rate=0.001
batch_size=32
pack_factor=3    # pack N utterances/row with state resets (numerically equivalent to unpacked: exact in f32); 1 = off
optimizer=adam
max_iter=30
sort_by_len=true
target_length_cutoff=3

. "$SCRIPTS/parse_options.sh" || exit 1
mkdir -p "$work" && cd "$work"

if [ "$stage" -le 1 ] && [ "$stop_stage" -ge 1 ]; then
  echo "===== stage 1: data prep + dict + LMs + decode graph ====="
  [ -z "$wsj0" ] && echo "need --wsj0 / --wsj1 (LDC corpora)" && exit 1
  bash "$LOCAL/wsj_data_prep.sh" "$wsj0" "$wsj1"
  bash "$LOCAL/wsj_prepare_phn_dict.sh" "$cmudict"
  if [ -z "$lm_arpa" ]; then
    # self-train the LMs from the training transcripts (reference
    # local/wsj_train_lms.sh via kaldi_lm; here the native KN trainer):
    # tg = unpruned trigram for rescoring, tgpr = pruned for decoding
    echo "no --lm-arpa: training trigram LMs from the training text"
    mkdir -p data/local/local_lm
    awk '{print $1}' data/local/dict_phn/lexicon.txt | sort -u \
      > data/local/local_lm/wordlist.txt
    $PYTHON "$BIN/train-lm.py" --order 3 \
      --wordlist data/local/local_lm/wordlist.txt \
      data/train_si284/text > data/local/local_lm/tg.arpa
    $PYTHON "$BIN/train-lm.py" --order 3 --prune 1e-7 \
      --wordlist data/local/local_lm/wordlist.txt \
      data/train_si284/text > data/local/local_lm/tgpr.arpa
    lm_arpa=data/local/local_lm/tgpr.arpa
    rescore_arpa=${rescore_arpa:-data/local/local_lm/tg.arpa}
  fi
  bash "$SCRIPTS/make_TLG.sh" data/local/dict_phn "$lm_arpa" \
    data/lang_phn_test_tgpr
  if [ -n "${rescore_arpa:-}" ]; then
    # const-arpa lang dir for the tg rescoring pass (reference
    # local/wsj_const_graph.sh + run_wsj_phn.sh:279-286)
    bash "$SCRIPTS/build_const_arpa_lm.sh" "$rescore_arpa" \
      data/lang_phn_test_tgpr data/lang_phn_test_tgconst
  fi
fi

if [ "$stage" -le 2 ] && [ "$stop_stage" -ge 2 ]; then
  echo "===== stage 2: fbank + CMVN ====="
  for set in train_si284 test_dev93 test_eval92; do
    dset=data/$set
    $PYTHON "$BIN/compute-fbank-feats.py" --config="$REPO/conf/fbank.conf" \
      "scp:$dset/wav.scp" "ark,scp:$dset/fbank.ark,$dset/feats.scp"
    $PYTHON "$BIN/compute-cmvn-stats.py" --spk2utt="ark:$dset/spk2utt" \
      "scp:$dset/feats.scp" "ark,scp:$dset/cmvn.ark,$dset/cmvn.scp"
  done
  # 95/5 train/cv split
  for set in tr95 cv05; do mkdir -p data/train_$set; done
  total=$(wc -l < data/train_si284/feats.scp)
  ncv=$((total / 20))
  head -n "$ncv" data/train_si284/feats.scp > data/train_cv05/feats.scp
  tail -n +"$((ncv+1))" data/train_si284/feats.scp \
    > data/train_tr95/feats.scp
  for set in tr95 cv05; do
    for f in text utt2spk wav.scp; do
      "$SCRIPTS/filter_scp.pl" -f 1 data/train_$set/feats.scp \
        < data/train_si284/$f > data/train_$set/$f
    done
    cp data/train_si284/cmvn.scp data/train_$set/cmvn.scp
    awk '{spk[$2]=spk[$2]" "$1} END {for (s in spk) print s spk[s]}' \
      data/train_$set/utt2spk | sort > data/train_$set/spk2utt
    # single global stats for conversion
    $PYTHON "$BIN/compute-cmvn-stats.py" "scp:data/train_$set/feats.scp" \
      data/train_$set/cmvn.mat
  done
fi

dir=exp/train_phn_l${num_layers}_c${num_neurons}_m${num_experts}
tfdata=data/records_phn

if [ "$stage" -le 3 ] && [ "$stop_stage" -ge 3 ]; then
  echo "===== stage 3: labels + records + label priors ====="
  mkdir -p "$tfdata" "$dir"
  for set in tr95 cv05; do
    tag=$( [ $set = tr95 ] && echo tr || echo cv )
    $PYTHON "$BIN/prep-ctc-trans.py" data/local/dict_phn/lexicon_numbers.txt \
        data/train_$set/text "<UNK>" |
      awk -v s=1 '{printf $1 " "; for(i=2;i<=NF;i++) printf($i-s)" "; print ""}' |
      $PYTHON "$BIN/copy-int-vector.py" ark:- \
        "ark,scp:$tfdata/label.$tag.ark,$tfdata/label.$tag.scp"
  done
  if $sort_by_len; then
    for pair in "tr95 tr" "cv05 cv"; do
      set=${pair% *}; tag=${pair#* }
      $PYTHON "$BIN/feat-to-len.py" scp:data/train_$set/feats.scp |
        awk '{print $2}' > "$tfdata/len.tmp"
      paste -d" " data/train_$set/feats.scp "$tfdata/len.tmp" |
        sort -k3 -n | awk '{print $1 " " $2}' \
        > "$tfdata/$tag.sorted.scp"
    done
    rm -f "$tfdata/len.tmp"
  else
    cp data/train_tr95/feats.scp "$tfdata/tr.sorted.scp"
    cp data/train_cv05/feats.scp "$tfdata/cv.sorted.scp"
  fi
  for pair in "tr95 tr" "cv05 cv"; do
    set=${pair% *}; tag=${pair#* }
    bash "$SCRIPTS/tfrecord.sh" --feats-scp "$tfdata/$tag.sorted.scp" \
      --trans-scp "$tfdata/label.$tag.scp" \
      --target-length-cutoff "$target_length_cutoff" \
      --cmvn-ark data/train_$set/cmvn.mat --add-deltas true --nj "$nj" \
      --dir "$tfdata/$tag"
  done
  # label priors (reference run_wsj_phn.sh:198-207)
  $PYTHON "$BIN/prep-ctc-trans.py" data/local/dict_phn/lexicon_numbers.txt \
      data/train_tr95/text "<UNK>" |
    awk '{line=$0; gsub(" "," 0 ",line); print line " 0";}' |
    $PYTHON "$BIN/analyze-counts.py" ark:- "$dir/label.counts"
fi

num_units=$(wc -l < data/local/dict_phn/units.txt)
num_targets=$((num_units + 1))

if [ "$stage" -le 4 ] && [ "$stop_stage" -ge 4 ]; then
  echo "===== stage 4: training ====="
  cat > "$dir/nnet.config" <<EOF
nnet_type = blstm
input_dim = 120
left_context = $left_context
right_context = $right_context
subsample = $subsample
num_layers = $num_layers
num_neurons = $num_neurons
num_projects = $num_projects
num_targets = $num_targets
use_peepholes = true
dropout_rate = $dropout_rate
num_experts = $num_experts
moe_temp = $moe_temp
seed = $seed
EOF
  bash "$SCRIPTS/train_oplr.sh" \
    --tr-tfrecords-scp "$tfdata/tr/tfrecords.scp" \
    --cv-tfrecords-scp "$tfdata/cv/tfrecords.scp" \
    --nnet-config "$dir/nnet.config" --dir "$dir" \
    --objective ctc --optimizer "$optimizer" --learn-rate "$learn_rate" \
    --max-iter "$max_iter" --batch-size "$batch_size" \
    --train-extra-opts "--pack-factor $pack_factor" \
    --cv-goal eval --shuffle true --num-targets "$num_targets"
  echo true > "$dir/norm_vars"
  echo true > "$dir/add_deltas"
  echo false > "$dir/subsample_feats"
  echo false > "$dir/splice_feats"
fi

if [ "$stage" -le 5 ] && [ "$stop_stage" -ge 5 ]; then
  echo "===== stage 5: decode dev93 + eval92 ====="
  # NOTE: splice/subsample happen inside the record pipeline via
  # nnet.config; the decode feature pipe adds deltas only.
  for set in dev93 eval92; do
    bash "$SCRIPTS/decode_ctc_lat.sh" --nj "$nj" --beam 17.0 \
      --lattice_beam 8.0 --max-active 5000 --acwt 0.9 \
      --ntargets "$num_targets" \
      data/lang_phn_test_tgpr data/test_$set "$dir/decode_$set"
  done
fi

if [ "$stage" -le 6 ] && [ "$stop_stage" -ge 6 ] && [ -f data/lang_phn_test_tgconst/G.carpa ]; then
  echo "===== stage 6: const-arpa tg rescore ====="
  for set in dev93 eval92; do
    bash "$SCRIPTS/lmrescore_const_arpa.sh" \
      data/lang_phn_test_tgpr data/lang_phn_test_tgconst \
      data/test_$set "$dir/decode_$set" "$dir/decode_${set}_tgconst"
  done
fi

echo "run_wsj_phn.sh: done"
