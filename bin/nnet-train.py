#!/usr/bin/env python3
"""Train one epoch of CTC and save the updated model.

CLI mirror of reference bin/nnet-train.py:26-160: same positional args
(<records.scp> <nnet-config> <nnet-in> <nnet-out>) and switches; restores
trainable parameters only (optimizer slots are rebuilt fresh each epoch,
matching the reference's Saver contract), trains one full pass, and logs
the greppable ``tr_loss`` line.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from lstm_ctc_tpu import logging_util as log
from lstm_ctc_tpu import parse_config
from lstm_ctc_tpu.cli import (
    build_batcher,
    check_objective_and_type,
    init_from_config,
    log_invocation,
    make_shard_fn,
    str2bool,
)
from lstm_ctc_tpu.data import iterate_batches
from lstm_ctc_tpu.train.checkpoint import load_checkpoint, save_checkpoint
from lstm_ctc_tpu.train.graph import make_train_step
from lstm_ctc_tpu.train.loop import MetricsWriter, run_training_epoch


def main(args):
    config = parse_config(args.nnet_config)
    config["is_training"] = True
    check_objective_and_type(args, config)

    template_params, template_state = init_from_config(config)
    params, net_state, _ = load_checkpoint(
        args.nnet_in, template_params, template_state)

    batcher = build_batcher(args.tfrecords_scp, config, args.batch_size,
                            pack_factor=args.pack_factor)
    if args.pack_factor > 1:
        # this process's packed batches all come from the batcher above,
        # which follows (and asserts) the rank-major slot contract —
        # declare it so the CTC gather can run row-batched under
        # shard_map on a mesh (train/graph.compute_losses)
        config["packed_slots_rank_major"] = True
    shard_fn, mesh = make_shard_fn()
    config["mesh"] = mesh  # the CTC kernels run per shard on a mesh
    init_opt, train_step = make_train_step(
        config,
        learn_rate=args.learn_rate,
        optimizer=args.optimizer,
        clip_norm=args.clip_norm,
    )
    opt_state = init_opt(params)

    rng = jax.random.PRNGKey(args.seed if args.seed is not None else 777)
    metrics_writer = MetricsWriter(args.metrics_file)
    if args.profile_dir:
        jax.profiler.start_trace(args.profile_dir)
    try:
        params, opt_state, net_state, _ = run_training_epoch(
            train_step, params, opt_state, net_state,
            iterate_batches(batcher, shuffle=args.shuffle, seed=args.seed),
            shard_fn, rng,
            report_interval=args.report_interval,
            metrics_writer=metrics_writer,
        )
    finally:
        metrics_writer.close()
        if args.profile_dir:
            jax.profiler.stop_trace()

    log.info('saving nnet to "%s"' % args.nnet_out)
    save_checkpoint(args.nnet_out, params, net_state)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("tfrecords_scp", metavar="<tfrecords.scp>", type=str,
                        help="records scp.")
    parser.add_argument("nnet_config", metavar="<nnet-config>", type=str,
                        help="nnet-config.")
    parser.add_argument("nnet_in", metavar="<nnet-in>", type=str,
                        help="nnet-in.")
    parser.add_argument("nnet_out", metavar="<nnet-out>", type=str,
                        help="nnet-out.")
    parser.add_argument("--objective", metavar="objective", type=str,
                        default="xent", help="objective function.")
    parser.add_argument("--optimizer", metavar="optimizer", type=str,
                        default="sgd", help="optimizer to be used.")
    parser.add_argument("--evaluate", metavar="evaluate", type=str2bool,
                        default="false",
                        help="whether to evaluate the model in addition to "
                             "loss.")
    parser.add_argument("--learn-rate", metavar="learn-rate", type=float,
                        default=0.0001, help="learning rate.")
    parser.add_argument("--batch-size", metavar="batch-size", type=int,
                        default=256, help="batch size.")
    parser.add_argument("--batch-threads", metavar="batch-threads", type=int,
                        default=8, help="accepted for compatibility.")
    parser.add_argument("--seed", metavar="seed", type=int, default=777,
                        help="seed for shuffling training data.")
    parser.add_argument("--num-parallel-calls", metavar="num-parallel-calls",
                        type=int, default=32,
                        help="accepted for compatibility.")
    parser.add_argument("--report-interval", metavar="report-interval",
                        type=int, default=100,
                        help="progress report interval.")
    parser.add_argument("--shuffle", metavar="do shuffle in the training",
                        type=str2bool, default="true",
                        help="whether to shuffle training data.")
    parser.add_argument("--clip-norm", metavar="gradient clip norm",
                        type=float, default=5.0, help="gradient clip norm")
    parser.add_argument("--pack-factor", metavar="pack-factor", type=int,
                        default=1,
                        help="pack up to N utterances per row with state "
                             "resets (blstm only; removes bucket-padding "
                             "waste, one compiled shape).")
    parser.add_argument("--metrics-file", metavar="metrics-file", type=str,
                        default=None,
                        help="append per-step scalar metrics as JSONL.")
    parser.add_argument("--profile-dir", metavar="profile-dir", type=str,
                        default=None,
                        help="capture a jax profiler trace for this epoch.")
    args = parser.parse_args()
    log_invocation()
    main(args)
