#!/usr/bin/env python3
"""Forward pass: write (log-)posteriors as a Kaldi matrix archive.

CLI mirror of reference bin/nnet-forward.py:29-159:
  * posterior = softmax(smooth_factor · logits);
  * ``--apply-log`` implies softmax and takes the log;
  * ``--class-prior`` subtracts the (blank-rotated) log prior, producing
    the pseudo-likelihoods the EESEN WFST decoder consumes
    (nnet-forward.py:87-91);
  * output keyed by utterance key, written through any Kaldi wspecifier so
    unmodified Kaldi/EESEN binaries can read it.

Unlike the reference's strictly batch-1 inference graph
(nnet/graph.py:212-241), utterances are batched through the bucketed
pipeline for throughput; per-utterance outputs are sliced back out.

``--streaming true`` (causal lstm/cudnnlstm models only) instead runs the
chunked streaming session (models/streaming.py) per utterance — the
deployment mode for low-latency serving; outputs are identical to the
offline pass.
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
from lstm_ctc_tpu.data import iterate_batches, scan_scp
from lstm_ctc_tpu.data.pipeline import iterate_utterances
from lstm_ctc_tpu.train.checkpoint import load_checkpoint
from lstm_ctc_tpu.train.class_prior import get_class_prior, subtract_log_prior
from lstm_ctc_tpu.models import apply_model


def main(args):
    config = parse_config(args.nnet_config)
    config["is_training"] = False
    if args.apply_log:
        args.apply_softmax = True

    class_prior = None if args.class_prior is None else \
        get_class_prior(args.class_prior)

    template_params, template_state = init_from_config(config)
    params, net_state, _ = load_checkpoint(
        args.nnet_in, template_params, template_state)

    smooth = args.smooth_factor

    if args.streaming:
        from lstm_ctc_tpu.models.streaming import StreamingSession
        writer = kaldi.BaseFloatMatrixWriter(args.nnet_output)
        processed = 0
        metas = scan_scp(args.tfrecords_scp)
        # ONE session for the whole archive: its jitted chunk step
        # compiles once; reset() clears per-utterance state between keys
        session = StreamingSession(params, net_state, config,
                                   chunk_size=args.chunk_frames)
        for key, raw, _ in iterate_utterances(metas):
            # session consumes RAW frames (it does splice/subsample itself)
            session.reset()
            logits = session.process(raw, flush=True)
            out = logits
            if args.apply_softmax:
                e = np.exp(smooth * logits
                           - (smooth * logits).max(axis=1, keepdims=True))
                out = e / e.sum(axis=1, keepdims=True)
            if args.apply_log:
                with np.errstate(divide="ignore"):
                    out = np.log(out)
            if class_prior is not None:
                out = subtract_log_prior(out, class_prior)
            writer.Write(key, out.astype(np.float32))
            processed += 1
            if args.report_interval and processed % args.report_interval == 0:
                log.info("processed = %d" % processed)
        log.info("done")
        writer.Close()
        return

    batcher = build_batcher(args.tfrecords_scp, config, args.batch_size,
                            need_labels=False)
    shard_fn, mesh = make_shard_fn()
    config["mesh"] = mesh  # the CTC kernels run per shard on a mesh

    @jax.jit
    def forward(nnet_input, sequence_length):
        logits, _, _, _ = apply_model(
            params, net_state, nnet_input, sequence_length, config,
            train=False)
        if args.apply_softmax:
            return jax.nn.softmax(smooth * logits)
        return logits

    writer = kaldi.BaseFloatMatrixWriter(args.nnet_output)
    processed = 0
    for batch in iterate_batches(batcher, shuffle=False):
        device_batch = shard_fn(batch)
        out = np.asarray(forward(device_batch["nnet_input"],
                                 device_batch["sequence_length"]))
        if args.apply_log:
            with np.errstate(divide="ignore"):
                out = np.log(out)
        if class_prior is not None:
            out = subtract_log_prior(out, class_prior)
        for row, key in enumerate(batch.keys):
            t_len = int(batch.sequence_length[row])
            writer.Write(key, out[row, :t_len].astype(np.float32))
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
    parser.add_argument("nnet_output", metavar="<nnet-output-wspecifier>",
                        type=str, help="wspecifier for nnet-output.")
    parser.add_argument("--apply-softmax", metavar="apply-softmax",
                        type=str2bool, default="true",
                        help="whether to apply softmax.")
    parser.add_argument("--apply-log", metavar="apply-log",
                        type=str2bool, default="true",
                        help="whether to apply log on top of softmax")
    parser.add_argument("--report-interval", metavar="report-interval",
                        type=int, default=100,
                        help="progress report interval.")
    parser.add_argument("--class-prior", metavar="class-prior", type=str,
                        default=None,
                        help="class prior to scale the softmax output")
    parser.add_argument("--smooth-factor", metavar="smooth factor",
                        type=float, default=1.0,
                        help="smooth factor for softmax")
    parser.add_argument("--batch-size", metavar="batch-size", type=int,
                        default=16, help="inference batch size.")
    parser.add_argument("--streaming", metavar="streaming", type=str2bool,
                        default="false",
                        help="chunked causal streaming inference "
                             "(lstm/cudnnlstm models).")
    parser.add_argument("--chunk-frames", metavar="chunk-frames", type=int,
                        default=32, help="streaming chunk size (frames).")
    args = parser.parse_args()
    log_invocation()
    main(args)
