#!/bin/bash
# LibriSpeech 960h phone-CTC recipe — staged pipeline mirroring the
# reference's egs/libri/run_libri_ph.sh:30-340 on this framework's
# native tooling.  Model defaults = the reference LibriSpeech config
# (run_libri_ph.sh:10-27): 4×BLSTM-320, adam 4e-4, batch 64, MoE 44
# experts temp 20.
#
# usage: run_libri_ph.sh --librispeech <root> --phn-dict <file> \
#            --lm-arpa <tgsmall.arpa> [opts]

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
librispeech=       # root containing train-clean-100/360, train-other-500,
                   # dev-clean, dev-other, test-clean, test-other
phn_dict=          # librispeech phoneme lexicon ("WORD ph ph ...")
lm_arpa=           # decoding LM (tgsmall); empty → local/download_lm.sh
lm_dir=data/local/lm   # where download_lm.sh puts/found the LMs
nj=32
seed=777

num_layers=4
num_neurons=320
num_projects=320
left_context=1
right_context=1
subsample=3
dropout_rate=0.9
num_experts=44
moe_temp=20
learn_rate=0.0004
batch_size=64
pack_factor=3    # pack N utterances/row with state resets (numerically equivalent to unpacked: exact in f32); 1 = off
optimizer=adam
max_iter=30
target_length_cutoff=3

. "$SCRIPTS/parse_options.sh" || exit 1
mkdir -p "$work" && cd "$work"

if [ "$stage" -le 1 ] && [ "$stop_stage" -ge 1 ]; then
  echo "===== stage 1: data prep + dict + LMs + decode graphs ====="
  [ -z "$librispeech" ] && echo "need --librispeech <root>" && exit 1
  bash "$LOCAL/libri_data_prep.sh" "$librispeech"
  [ -z "$phn_dict" ] && echo "need --phn-dict" && exit 1
  bash "$LOCAL/libri_prepare_phn_dict.sh" "$phn_dict"
  if [ -z "$lm_arpa" ]; then
    bash "$LOCAL/download_lm.sh" "$lm_dir"
    lm_arpa="$lm_dir/lm_tgsmall.arpa.gz"
  fi
  # decode graphs: tgsmall + tgmed (reference run_libri_ph.sh:328-331)
  bash "$SCRIPTS/make_TLG.sh" data/local/dict_phn "$lm_arpa" \
    data/lang_phn_test_tgsmall
  if [ -f "$lm_dir/lm_tgmed.arpa.gz" ]; then
    bash "$SCRIPTS/make_TLG.sh" data/local/dict_phn \
      "$lm_dir/lm_tgmed.arpa.gz" data/lang_phn_test_tgmed
  fi
  # const-arpa rescoring dirs: tglarge + fglarge (reference
  # run_libri_ph.sh:333-337, local/ls_const_graph.sh)
  for lm in tglarge fglarge; do
    if [ -f "$lm_dir/lm_$lm.arpa.gz" ]; then
      bash "$SCRIPTS/build_const_arpa_lm.sh" "$lm_dir/lm_$lm.arpa.gz" \
        data/lang_phn_test_tgsmall data/lang_phn_test_$lm
    fi
  done
fi

if [ "$stage" -le 2 ] && [ "$stop_stage" -ge 2 ]; then
  echo "===== stage 2: fbank + CMVN ====="
  # merge the three training subsets into train_960
  mkdir -p data/train_960
  for f in wav.scp text utt2spk; do
    cat data/train_clean_100/$f data/train_clean_360/$f \
        data/train_other_500/$f | sort > data/train_960/$f
  done
  awk '{spk[$2]=spk[$2]" "$1} END {for (s in spk) print s spk[s]}' \
    data/train_960/utt2spk | sort > data/train_960/spk2utt
  for set in train_960 dev_clean dev_other test_clean test_other; do
    dset=data/$set
    $PYTHON "$BIN/compute-fbank-feats.py" --config="$REPO/conf/fbank.conf" \
      "scp:$dset/wav.scp" "ark,scp:$dset/fbank.ark,$dset/feats.scp"
    $PYTHON "$BIN/compute-cmvn-stats.py" --spk2utt="ark:$dset/spk2utt" \
      "scp:$dset/feats.scp" "ark,scp:$dset/cmvn.ark,$dset/cmvn.scp"
  done
  # 95/5 split for cv
  total=$(wc -l < data/train_960/feats.scp)
  ncv=$((total / 20))
  for set in tr95 cv05; do mkdir -p data/train_$set; done
  head -n "$ncv" data/train_960/feats.scp > data/train_cv05/feats.scp
  tail -n +"$((ncv+1))" data/train_960/feats.scp > data/train_tr95/feats.scp
  for set in tr95 cv05; do
    for f in text utt2spk; do
      "$SCRIPTS/filter_scp.pl" -f 1 data/train_$set/feats.scp \
        < data/train_960/$f > data/train_$set/$f
    done
    $PYTHON "$BIN/compute-cmvn-stats.py" "scp:data/train_$set/feats.scp" \
      data/train_$set/cmvn.mat
  done
fi

dir=exp/train_phn_l${num_layers}_c${num_neurons}_m${num_experts}
tfdata=data/records_phn

if [ "$stage" -le 3 ] && [ "$stop_stage" -ge 3 ]; then
  echo "===== stage 3: labels + records + priors ====="
  mkdir -p "$tfdata" "$dir"
  for pair in "tr95 tr" "cv05 cv"; do
    set=${pair% *}; tag=${pair#* }
    $PYTHON "$BIN/prep-ctc-trans.py" data/local/dict_phn/lexicon_numbers.txt \
        data/train_$set/text "<UNK>" |
      awk -v s=1 '{printf $1 " "; for(i=2;i<=NF;i++) printf($i-s)" "; print ""}' |
      $PYTHON "$BIN/copy-int-vector.py" ark:- \
        "ark,scp:$tfdata/label.$tag.ark,$tfdata/label.$tag.scp"
    bash "$SCRIPTS/tfrecord.sh" --feats-scp data/train_$set/feats.scp \
      --trans-scp "$tfdata/label.$tag.scp" \
      --target-length-cutoff "$target_length_cutoff" \
      --cmvn-ark data/train_$set/cmvn.mat --add-deltas true --nj "$nj" \
      --dir "$tfdata/$tag"
  done
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
  echo "===== stage 5: decode 4 test sets (tgsmall + tgmed) ====="
  for set in dev_clean dev_other test_clean test_other; do
    bash "$SCRIPTS/decode_ctc_lat.sh" --nj "$nj" --beam 17.0 \
      --lattice_beam 8.0 --max-active 5000 --acwt 0.9 \
      --ntargets "$num_targets" \
      data/lang_phn_test_tgsmall data/$set "$dir/decode_${set}_tgsmall"
    if [ -f data/lang_phn_test_tgmed/TLG.fst ]; then
      bash "$SCRIPTS/decode_ctc_lat.sh" --nj "$nj" --beam 17.0 \
        --lattice_beam 8.0 --max-active 5000 --acwt 0.9 \
        --ntargets "$num_targets" \
        data/lang_phn_test_tgmed data/$set "$dir/decode_${set}_tgmed"
    fi
  done
fi

if [ "$stage" -le 6 ] && [ "$stop_stage" -ge 6 ]; then
  echo "===== stage 6: tglarge/fglarge const-arpa rescore ====="
  # reference run_libri_ph.sh:333-337 (steps/lmrescore_const_arpa.sh)
  for set in dev_clean dev_other test_clean test_other; do
    for lm in tglarge fglarge; do
      if [ -f data/lang_phn_test_$lm/G.carpa ]; then
        bash "$SCRIPTS/lmrescore_const_arpa.sh" \
          data/lang_phn_test_tgsmall data/lang_phn_test_$lm \
          data/$set "$dir/decode_${set}_tgsmall" \
          "$dir/decode_${set}_tgsmall_$lm"
      fi
    done
  done
fi

echo "run_libri_ph.sh: done"
