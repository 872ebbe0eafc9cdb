#!/usr/bin/env python3
"""Greedy/beam CTC decode to an Int32Vector archive (debug/PER path).

Intended-behavior implementation of reference bin/nnet-decode.py:27-128,
whose graph path (nnet/graph.py:244-281) is unrunnable due to a stale
model-fn unpacking; used by the debug decode in scripts/decode.sh:41-56.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from lstm_ctc_tpu import kaldi, logging_util as log, parse_config
from lstm_ctc_tpu.cli import (
    build_batcher,
    init_from_config,
    log_invocation,
    make_shard_fn,
    str2bool,
)
from lstm_ctc_tpu.data import iterate_batches
from lstm_ctc_tpu.models import apply_model
from lstm_ctc_tpu.ops.decode import beam_search_decode, greedy_decode
from lstm_ctc_tpu.train.checkpoint import load_checkpoint


def main(args):
    config = parse_config(args.nnet_config)
    config["is_training"] = False

    template_params, template_state = init_from_config(config)
    params, net_state, _ = load_checkpoint(
        args.nnet_in, template_params, template_state)

    batcher = build_batcher(args.tfrecords_scp, config, args.batch_size,
                            need_labels=False)
    shard_fn, mesh = make_shard_fn()
    config["mesh"] = mesh  # the CTC kernels run per shard on a mesh

    @jax.jit
    def forward(nnet_input, sequence_length):
        logits, _, _, _ = apply_model(
            params, net_state, nnet_input, sequence_length, config,
            train=False)
        return jax.nn.log_softmax(logits)

    writer = kaldi.Int32VectorWriter(args.output)
    processed = 0
    for batch in iterate_batches(batcher, shuffle=False):
        device_batch = shard_fn(batch)
        log_probs = np.asarray(forward(device_batch["nnet_input"],
                                       device_batch["sequence_length"]))
        if args.beam_width > 1:
            hyps = [beam_search_decode(
                        log_probs[b, :int(batch.sequence_length[b])],
                        beam_width=args.beam_width)[0]
                    for b in range(len(batch.keys))]
        else:
            hyps = greedy_decode(log_probs[:len(batch.keys)],
                                 batch.sequence_length[:len(batch.keys)])
        for key, hyp in zip(batch.keys, hyps):
            writer.Write(key, np.asarray(hyp, np.int32))
            processed += 1
            if args.report_interval and processed % args.report_interval == 0:
                log.info("processed = %d" % processed)
    log.info("done")
    writer.Close()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("tfrecords_scp", metavar="<tfrecords-scp>", type=str,
                        help="records scp.")
    parser.add_argument("nnet_config", metavar="<nnet-config>", type=str,
                        help="nnet-config.")
    parser.add_argument("nnet_in", metavar="<nnet-in>", type=str,
                        help="nnet-in.")
    parser.add_argument("output", metavar="<output-wspecifier>", type=str,
                        help="wspecifier for decoded label sequences.")
    parser.add_argument("--report-interval", metavar="report-interval",
                        type=int, default=100,
                        help="progress report interval.")
    parser.add_argument("--beam-width", metavar="beam-width", type=int,
                        default=1,
                        help="CTC beam width; 1 = greedy.")
    parser.add_argument("--batch-size", metavar="batch-size", type=int,
                        default=16, help="inference batch size.")
    args = parser.parse_args()
    log_invocation()
    main(args)
