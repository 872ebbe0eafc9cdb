#!/usr/bin/env python3
"""Cross-validate a model: one CV epoch, logs cv_loss/cv_eval.

CLI mirror of reference bin/nnet-validate.py:26-136.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

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
from lstm_ctc_tpu.train.checkpoint import load_checkpoint
from lstm_ctc_tpu.train.graph import make_eval_step
from lstm_ctc_tpu.train.loop import run_validation_epoch


def main(args):
    config = parse_config(args.nnet_config)
    config["is_training"] = False
    check_objective_and_type(args, config)

    template_params, template_state = init_from_config(config)
    params, net_state, _ = load_checkpoint(
        args.nnet_in, template_params, template_state)

    batcher = build_batcher(args.tfrecords_scp, config, args.batch_size)
    shard_fn, mesh = make_shard_fn()
    config["mesh"] = mesh  # the CTC kernels run per shard on a mesh
    eval_step = make_eval_step(config, with_logits=args.evaluate)

    run_validation_epoch(
        eval_step, params, net_state,
        iterate_batches(batcher, shuffle=False),
        shard_fn,
        evaluate=args.evaluate,
        report_interval=args.report_interval,
    )


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("tfrecords_scp", metavar="<tfrecords.scp>", type=str,
                        help="records scp.")
    parser.add_argument("nnet_config", metavar="<nnet-config>", type=str,
                        help="nnet-config.")
    parser.add_argument("nnet_in", metavar="<nnet-in>", type=str,
                        help="nnet-in.")
    parser.add_argument("--objective", metavar="objective", type=str,
                        default="xent", help="objective function.")
    parser.add_argument("--evaluate", metavar="evaluate", type=str2bool,
                        default="false",
                        help="whether to evaluate the model in addition to "
                             "loss.")
    parser.add_argument("--batch-size", metavar="batch-size", type=int,
                        default=256, help="batch size.")
    parser.add_argument("--batch-threads", metavar="batch-threads", type=int,
                        default=8, help="accepted for compatibility.")
    parser.add_argument("--num-parallel-calls", metavar="num-parallel-calls",
                        type=int, default=32,
                        help="accepted for compatibility.")
    parser.add_argument("--report-interval", metavar="report-interval",
                        type=int, default=100,
                        help="progress report interval.")
    args = parser.parse_args()
    log_invocation()
    main(args)
