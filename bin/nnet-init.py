#!/usr/bin/env python3
"""Initialize a model: random init + one CV pass, saved as iteration 0.

CLI mirror of reference bin/nnet-init.py:25-135 (same positional args and
switches); the initial cross-validation gives the outer training loop its
starting ``cv_loss`` (reference scripts/train.sh:71-114).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

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
from lstm_ctc_tpu.train.checkpoint import save_checkpoint
from lstm_ctc_tpu.train.graph import make_eval_step
from lstm_ctc_tpu.train.loop import run_validation_epoch


def main(args):
    config = parse_config(args.nnet_config)
    config["is_training"] = False
    check_objective_and_type(args, config)

    params, net_state = init_from_config(config)

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

    log.info('saving nnet to "%s"' % args.nnet_out)
    save_checkpoint(args.nnet_out, params, net_state)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("tfrecords_scp", metavar="<tfrecords.scp>", type=str,
                        help="records scp.")
    parser.add_argument("nnet_config", metavar="<nnet-config>", type=str,
                        help="nnet-config.")
    parser.add_argument("nnet_out", metavar="<nnet-out>", type=str,
                        help="nnet-out.")
    parser.add_argument("--objective", metavar="objective", type=str,
                        default="xent", help="objective function.")
    parser.add_argument("--evaluate", metavar="evaluate", type=str2bool,
                        default="false",
                        help="whether to evaluate the model in addition to "
                             "loss.")
    parser.add_argument("--batch-size", metavar="batch-size", type=int,
                        default=256, help="batch size.")
    parser.add_argument("--batch-threads", metavar="batch-threads", type=int,
                        default=8, help="batch threads (accepted for "
                                        "compatibility).")
    parser.add_argument("--num-parallel-calls", metavar="num-parallel-calls",
                        type=int, default=32,
                        help="accepted for compatibility.")
    parser.add_argument("--report-interval", metavar="report-interval",
                        type=int, default=100,
                        help="progress report interval.")
    args = parser.parse_args()
    log_invocation()
    main(args)
