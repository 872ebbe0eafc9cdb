#!/usr/bin/env python3
"""In-process outer training loop ("oplr" newbob schedule, one process).

Exactly the state machine of scripts/train_oplr.sh (reference
scripts/train_oplr.sh:121-259 — accept/reject on a CV goal, LR halving
with release threshold, NaN retry-once, min_iters/keep_lr_iters), but
all iterations run inside ONE process sharing one jax client: per-epoch
semantics are preserved bit-for-bit (optimizer state rebuilt fresh each
epoch — the reference's Saver contract persists trainable params only;
per-epoch shuffle/dropout seed = iteration number; epoch input = the
best checkpoint so far), while the per-process accelerator-runtime
warmup the script loop pays ~2×/iteration is paid once.

Intended for runs where per-process start-up and compilation dominate
short epochs; produces the same artifact tree as
train_oplr.sh (nnet.N checkpoints, nnet.N.done stats, final.nnet,
metrics JSONL) and is resumable off the same .done markers — the
equivalence is pinned by tests/test_train_loop_inproc.py, which runs
both drivers on CPU and compares checkpoints exactly.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

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
from lstm_ctc_tpu.train.graph import make_eval_step, make_train_step
from lstm_ctc_tpu.train.loop import (
    MetricsWriter,
    run_training_epoch,
    run_validation_epoch,
)


def stamp():
    return time.strftime("[%Y/%m/%d %H:%M:%S]")


def to_host(tree):
    """Pull a pytree to host numpy.  train_step donates its params/
    opt_state/net_state buffers (deleted after the step on the device), so the
    retained best-so-far trees must live on host and be re-fed each
    epoch — otherwise the first rejected epoch reuses a deleted array."""
    return jax.tree.map(lambda x: np.asarray(x), tree)


def read_done(path):
    vals = {}
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) == 2:
                vals[parts[0]] = float(parts[1])
    return vals


def write_done(path, **vals):
    with open(path, "w") as fh:
        for k, v in vals.items():
            fh.write("%s %.6f\n" % (k, v))


def main(args):
    outdir = args.dir
    os.makedirs(outdir, exist_ok=True)
    config_dst = os.path.join(outdir, "nnet.config")
    if os.path.realpath(args.nnet_config) != os.path.realpath(config_dst):
        with open(args.nnet_config) as src, open(config_dst, "w") as dst:
            dst.write(src.read())
    config = parse_config(config_dst)
    config["is_training"] = True
    check_objective_and_type(args, config)

    tr_batcher = build_batcher(args.tr_tfrecords_scp, config,
                               args.batch_size,
                               pack_factor=args.pack_factor)
    # the CV pass never packs (mirrors nnet-validate.py)
    cv_config = dict(config)
    cv_batcher = build_batcher(args.cv_tfrecords_scp, cv_config,
                               args.batch_size)
    if args.pack_factor > 1:
        # declared AFTER the cv copy: only the training batcher packs,
        # and it follows (and asserts) the rank-major slot contract
        config["packed_slots_rank_major"] = True
    shard_fn, mesh = make_shard_fn()
    config["mesh"] = mesh
    cv_config["mesh"] = mesh
    eval_step = make_eval_step(cv_config, with_logits=True)

    def validate(params, net_state):
        stats = run_validation_epoch(
            eval_step, params, net_state,
            iterate_batches(cv_batcher, shuffle=False),
            shard_fn, evaluate=True,
            report_interval=args.report_interval)
        return float(stats.loss), float(stats.eval)

    def train_epoch(params, net_state, learn_rate, seed, metrics_path):
        init_opt, train_step = make_train_step(
            config, learn_rate=learn_rate, optimizer=args.optimizer,
            clip_norm=args.clip_norm)
        # fresh optimizer state every epoch: the reference checkpoints
        # trainable variables only (nnet-train.py Saver contract)
        opt_state = init_opt(params)
        rng = jax.random.PRNGKey(seed)
        writer = MetricsWriter(metrics_path)
        try:
            params, _, net_state, stats = run_training_epoch(
                train_step, params, opt_state, net_state,
                iterate_batches(tr_batcher, shuffle=args.shuffle,
                                seed=seed),
                shard_fn, rng,
                report_interval=args.report_interval,
                metrics_writer=writer)
        finally:
            writer.close()
        return to_host(params), to_host(net_state), float(stats.loss)

    template_params, template_state = init_from_config(config)

    # ---- iteration 0: init + CV (train_oplr.sh:86-120) ----
    print("%s iteration 0" % stamp(), flush=True)
    nnet0 = os.path.join(outdir, "nnet.0")
    done0 = nnet0 + ".done"
    if os.path.exists(done0):
        params, net_state, _ = load_checkpoint(
            nnet0, template_params, template_state)
        params, net_state = to_host(params), to_host(net_state)
        vals = read_done(done0)
        cv_loss_best, cv_eval_best = vals["cv_loss"], vals["cv_eval"]
    else:
        params = to_host(template_params)
        net_state = to_host(template_state)
        save_checkpoint(nnet0, params, net_state)
        cv_loss_best, cv_eval_best = validate(params, net_state)
        write_done(done0, cv_loss=cv_loss_best, cv_eval=cv_eval_best)
    cv_goal_best = cv_loss_best if args.cv_goal == "loss" else cv_eval_best
    print("cv_goal_best = %.6f" % cv_goal_best, flush=True)

    best_params, best_state = params, net_state
    best_name = "nnet.0"
    learn_rate = args.learn_rate
    halving = 0

    for it in range(1, args.max_iter + 1):
        nnet_out = os.path.join(outdir, "nnet.%d" % it)
        done = nnet_out + ".done"
        print("\n%s iteration %d" % (stamp(), it), flush=True)
        if os.path.exists(done):
            print("%s exists, skipping this iteration" % done, flush=True)
            vals = read_done(done)
            tr_loss = vals["tr_loss"]
            cv_loss, cv_eval = vals["cv_loss"], vals["cv_eval"]
            params, net_state, _ = load_checkpoint(
                nnet_out, template_params, template_state)
            params, net_state = to_host(params), to_host(net_state)
        else:
            print("training with learn_rate = %g" % learn_rate, flush=True)
            print("nnet_in = %s" % best_name, flush=True)
            print("nnet_out = %s" % nnet_out, flush=True)
            metrics_path = os.path.join(
                outdir, "nnet.%d.metrics.jsonl" % it)

            def attempt(lr):
                try:
                    return train_epoch(best_params, best_state, lr, it,
                                       metrics_path)
                except SystemExit:
                    return None   # NaN abort inside the epoch loop

            result = attempt(learn_rate)
            if result is None or not np.isfinite(result[2]):
                # NaN retry-once with halved LR (train_oplr.sh:145-159)
                learn_rate = learn_rate * args.halving_factor
                print("(ERROR) tr_loss = nan; reduce learn rate and "
                      "re-train\ntraining with learn_rate = %g"
                      % learn_rate, flush=True)
                result = attempt(learn_rate)
                if result is None or not np.isfinite(result[2]):
                    print("(ERROR) tr_loss = nan", flush=True)
                    sys.exit(1)
            params, net_state, tr_loss = result
            save_checkpoint(nnet_out, params, net_state)
            cv_loss, cv_eval = validate(params, net_state)
            if not (np.isfinite(cv_loss) and np.isfinite(cv_eval)):
                print("(ERROR) cv_loss = nan", flush=True)
                sys.exit(1)
            write_done(done, tr_loss=tr_loss, cv_loss=cv_loss,
                       cv_eval=cv_eval)
            with open(os.path.join(outdir, "final.nnet"), "w") as fh:
                fh.write("nnet.%d\n" % it)
        print("tr_loss = %.6f cv_loss = %.6f cv_eval = %.6f"
              % (tr_loss, cv_loss, cv_eval), flush=True)

        cv_goal_val = cv_loss if args.cv_goal == "loss" else cv_eval
        # a collapsed run can reach cv goal exactly 0 (observed under a
        # deliberate lr×10 regression); 0-best means no relative
        # improvement is measurable — mirror the scripts' guarded awk
        rel_impr = ((cv_goal_best - cv_goal_val)
                    / (cv_goal_best if cv_goal_best != 0 else 1e-20))
        print("cv_goal_val = %.6f cv_goal_best = %.6f relative "
              "improvement = %.6f" % (cv_goal_val, cv_goal_best, rel_impr),
              flush=True)

        if cv_goal_val < cv_goal_best:
            best_params, best_state = params, net_state
            best_name = "nnet.%d" % it
            cv_goal_best = cv_goal_val
            print("nnet accepted (%s)" % best_name, flush=True)
        else:
            print("nnet rejected (nnet.%d)" % it, flush=True)

        if it <= args.keep_lr_iters:
            continue

        if halving == 1 and rel_impr < args.end_halving_impr:
            if it <= args.min_iters:
                print("supposed to finish, but we continue as "
                      "min_iters = %d" % args.min_iters, flush=True)
                learn_rate = max(learn_rate * args.halving_factor,
                                 args.min_learning_rate)
                print("halved learning rate to %g" % learn_rate,
                      flush=True)
                continue
            print("finished, too small rel. improvement %g < %g"
                  % (rel_impr, args.end_halving_impr), flush=True)
            break

        if halving == 0 and rel_impr < args.start_halving_impr:
            print("start halving learning rate, small rel. improvement "
                  "%g < %g" % (rel_impr, args.start_halving_impr),
                  flush=True)
            halving = 1

        if rel_impr > args.stop_halving_impr:
            print("stop halving learning rate, big rel. improvement "
                  "%g > %g" % (rel_impr, args.stop_halving_impr),
                  flush=True)
            halving = 0

        if halving == 1:
            learn_rate = max(learn_rate * args.halving_factor,
                             args.min_learning_rate)
            print("halved learning rate to %g" % learn_rate, flush=True)

    with open(os.path.join(outdir, "final.nnet"), "w") as fh:
        fh.write("%s\n" % best_name)
    print("%s training finished, the final model is %s/%s"
          % (stamp(), outdir, best_name), flush=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--tr-tfrecords-scp", required=True, type=str)
    parser.add_argument("--cv-tfrecords-scp", required=True, type=str)
    parser.add_argument("--nnet-config", required=True, type=str)
    parser.add_argument("--dir", required=True, type=str)
    parser.add_argument("--objective", type=str, default="xent")
    parser.add_argument("--optimizer", type=str, default="momentum")
    parser.add_argument("--learn-rate", type=float, default=0.008)
    parser.add_argument("--max-iter", type=int, default=30)
    parser.add_argument("--min-iters", type=int, default=30)
    parser.add_argument("--keep-lr-iters", type=int, default=0)
    parser.add_argument("--start-halving-impr", type=float, default=0.001)
    parser.add_argument("--end-halving-impr", type=float, default=0.0001)
    parser.add_argument("--stop-halving-impr", type=float, default=0.01)
    parser.add_argument("--halving-factor", type=float, default=0.5)
    parser.add_argument("--min-learning-rate", type=float, default=1e-5)
    parser.add_argument("--shuffle", type=str2bool, default="false")
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--clip-norm", type=float, default=5.0)
    parser.add_argument("--cv-goal", type=str, default="eval",
                        choices=["loss", "eval"])
    parser.add_argument("--pack-factor", type=int, default=1)
    parser.add_argument("--report-interval", type=int, default=100)
    args = parser.parse_args()
    log_invocation()
    main(args)
