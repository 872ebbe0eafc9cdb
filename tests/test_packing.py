"""Multi-utterance row packing: packed rows with state resets must be
EXACTLY equivalent to giving each utterance its own row — outputs, CTC
losses, and parameter gradients (no dropout, f32 everywhere).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lstm_ctc_tpu.models import apply_model, init_model
from lstm_ctc_tpu.models.cells import reverse_segments, reverse_sequence
from lstm_ctc_tpu.train.graph import compute_losses

CONFIG = {
    "nnet_type": "blstm",
    "input_dim": 6,
    "left_context": 0,
    "right_context": 0,
    "subsample": 0,
    "num_layers": 2,
    "num_neurons": 10,
    "num_projects": 8,
    "num_targets": 5,
    "use_peepholes": True,
    "dropout_rate": 1.0,
    "num_experts": 0,
    # the hand-built packed batches below lay slots out rank-major
    # exactly like data/pipeline._assemble_packed; declare it so
    # compute_losses uses the row-batched gather (the undeclared case
    # is covered by test_undeclared_contract_falls_back_to_flat_gather)
    "packed_slots_rank_major": True,
}

UTT_LENS = [7, 5, 9, 3]          # four utterances
ROW_T = 16                       # rows: [7+5], [9+3]
UTT_T = 12                       # per-utterance padded length


def make_utts(seed=0):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(t, 6).astype(np.float32) for t in UTT_LENS]
    labels = [rng.randint(0, 4, max(1, t // 3)).astype(np.int32)
              for t in UTT_LENS]
    return feats, labels


# rank-major slot layout — the pipeline contract (_assemble_packed):
# row r's rank-k (k-th longest) utterance lives at slot k·B + r, so a
# slot's owning row is slot % B.  rows [[0,1],[2,3]] longest-first →
SLOT_OF_UTT = [0, 2, 1, 3]


def packed_batch(feats, labels):
    rows = [[0, 1], [2, 3]]
    n_rows = len(rows)
    x = np.zeros((2, ROW_T, 6), np.float32)
    seq = np.zeros((2,), np.int32)
    reset = np.zeros((2, ROW_T), np.float32)
    n = len(feats)
    u_max = max(len(l) for l in labels)
    tgt = np.full((n, u_max), -1, np.int32)
    tlen = np.zeros((n,), np.int32)
    useq = np.zeros((n,), np.int32)
    uidx = np.zeros((n, UTT_T), np.int32)
    for r, members in enumerate(rows):
        off = 0
        for rank, j in enumerate(members):
            slot = rank * n_rows + r
            assert slot == SLOT_OF_UTT[j]
            t = feats[j].shape[0]
            x[r, off:off + t] = feats[j]
            reset[r, off] = 1.0
            tgt[slot, :len(labels[j])] = labels[j]
            tlen[slot] = len(labels[j])
            useq[slot] = t
            uidx[slot] = np.minimum(off + np.arange(UTT_T), ROW_T - 1) \
                + r * ROW_T
            off += t
        seq[r] = off
    return {
        "nnet_input": jnp.asarray(x),
        "sequence_length": jnp.asarray(seq),
        "nnet_target": jnp.asarray(tgt),
        "target_length": jnp.asarray(tlen),
        "reset_mask": jnp.asarray(reset),
        "utt_time_index": jnp.asarray(uidx),
        "utt_sequence_length": jnp.asarray(useq),
    }


def unpacked_batch(feats, labels):
    n = len(feats)
    u_max = max(len(l) for l in labels)
    x = np.zeros((n, UTT_T, 6), np.float32)
    seq = np.zeros((n,), np.int32)
    tgt = np.full((n, u_max), -1, np.int32)
    tlen = np.zeros((n,), np.int32)
    for j in range(n):
        t = feats[j].shape[0]
        x[j, :t] = feats[j]
        seq[j] = t
        tgt[j, :len(labels[j])] = labels[j]
        tlen[j] = len(labels[j])
    return {
        "nnet_input": jnp.asarray(x),
        "sequence_length": jnp.asarray(seq),
        "nnet_target": jnp.asarray(tgt),
        "target_length": jnp.asarray(tlen),
    }


def test_reverse_segments_matches_reverse_sequence_single_segment():
    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(3, 11, 4).astype(np.float32))
    seq = jnp.asarray([11, 6, 0], jnp.int32)
    reset = np.zeros((3, 11), np.float32)
    reset[:, 0] = 1.0
    got = reverse_segments(x, seq, jnp.asarray(reset))
    ref = reverse_sequence(x, seq)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref))


def test_packed_logits_match_unpacked():
    feats, labels = make_utts()
    params, net_state = init_model(jax.random.PRNGKey(0), CONFIG)
    packed = packed_batch(feats, labels)
    unpacked = unpacked_batch(feats, labels)

    logits_p, _, _, _ = apply_model(
        params, net_state, packed["nnet_input"],
        packed["sequence_length"], CONFIG, train=False,
        reset_mask=packed["reset_mask"])
    flat = np.asarray(logits_p).reshape(2 * ROW_T, -1)
    per_utt = flat[np.asarray(packed["utt_time_index"])]

    logits_u, _, _, _ = apply_model(
        params, net_state, unpacked["nnet_input"],
        unpacked["sequence_length"], CONFIG, train=False)
    logits_u = np.asarray(logits_u)

    for j, t in enumerate(UTT_LENS):
        np.testing.assert_allclose(per_utt[SLOT_OF_UTT[j], :t],
                                   logits_u[j, :t],
                                   rtol=2e-5, atol=2e-5,
                                   err_msg="utt %d" % j)


def test_packed_loss_and_grads_match_unpacked():
    feats, labels = make_utts(seed=5)
    params, net_state = init_model(jax.random.PRNGKey(1), CONFIG)
    packed = packed_batch(feats, labels)
    unpacked = unpacked_batch(feats, labels)

    def loss_of(batch):
        def f(p):
            metrics, _, _ = compute_losses(p, net_state, batch, CONFIG,
                                           train=False)
            return metrics["eval_loss"], metrics["size"]
        (value, size), grads = jax.value_and_grad(f, has_aux=True)(params)
        return float(value), int(size), grads

    lp, sp, gp = loss_of(packed)
    lu, su, gu = loss_of(unpacked)
    assert sp == su
    np.testing.assert_allclose(lp, lu, rtol=1e-5)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(gp),
            jax.tree_util.tree_leaves_with_path(gu)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=str(path))


def test_nonconforming_slot_count_falls_back_to_flat_gather():
    """A slot count off the pipeline's rank-major contract (n_slots not
    a multiple of num_rows — e.g. an external producer) must not crash
    the row-batched gather and must still compute the exact flat-gather
    loss over the slots it does carry."""
    feats, labels = make_utts(seed=6)
    params, net_state = init_model(jax.random.PRNGKey(1), CONFIG)
    packed = packed_batch(feats, labels)
    # drop the last slot (row 1's rank-1 utterance = utt 3): 3 slots
    # over 2 rows — non-conforming; indices stay GLOBAL-flat, as the
    # pre-contract producers emitted them
    trimmed = dict(packed)
    for key in ("utt_time_index", "utt_sequence_length",
                "nnet_target", "target_length"):
        trimmed[key] = packed[key][:3]

    def eval_loss(batch):
        metrics, _, _ = compute_losses(params, net_state, batch, CONFIG,
                                       train=False)
        return float(metrics["eval_loss"])

    # expected: the unpacked per-utterance losses of the three kept
    # utterances (slot j holds utt SLOT_OF_UTT.index(j))
    kept = [SLOT_OF_UTT.index(j) for j in range(3)]
    unpacked = unpacked_batch(feats, labels)
    per_utt = []
    for u in kept:
        single = {k: v[u:u + 1] for k, v in unpacked.items()}
        per_utt.append(eval_loss(single))
    np.testing.assert_allclose(eval_loss(trimmed), sum(per_utt),
                               rtol=1e-5)


def test_batcher_packs_all_utterances():
    """batch_plan(-1) covers every utterance exactly once and assemble
    reproduces each utterance's features at its packed offset."""
    from lstm_ctc_tpu.data.pipeline import BucketedBatcher
    from lstm_ctc_tpu.data.records import RecordMeta

    rng = np.random.RandomState(11)
    lens = [9, 17, 4, 30, 12, 7, 21, 3, 27, 14]
    metas = [RecordMeta("utt%02d" % i, t, 6, True, "mem", i)
             for i, t in enumerate(lens)]
    feats = {m.key: rng.randn(m.num_rows, 6).astype(np.float32)
             for m in metas}
    labs = {m.key: rng.randint(0, 4, 2 + i % 3).astype(np.int32)
            for i, m in enumerate(metas)}

    class FakeLoader:
        def load(self, meta):
            return meta.key, feats[meta.key], labs[meta.key]

        def close(self):
            pass

    b = BucketedBatcher(metas, batch_size=2, pack_factor=3,
                        time_quant=8, label_quant=4,
                        label_lengths=[len(labs[m.key]) for m in metas])
    assert b.shapes() == [(32, 4)]
    plan = b.batch_plan(shuffle=True, seed=0)
    seen = []
    for bucket_idx, rows in plan:
        assert bucket_idx == -1
        batch = b.assemble(bucket_idx, rows, FakeLoader())
        n_slots = batch.nnet_target.shape[0]
        assert n_slots == 2 * 3
        flat = batch.nnet_input.reshape(-1, 6)
        row_t = batch.nnet_input.shape[1]
        for row, row_members in enumerate(rows):
            # slots are rank-major: row r's (k+1)-th longest → slot k·B+r
            ordered = sorted(row_members,
                             key=lambda i: -metas[i].num_rows)
            for rank, idx in enumerate(ordered):
                slot = rank * 2 + row
                key = metas[idx].key
                t = metas[idx].num_rows
                # tier-width invariant behind the tiered CTC gather
                assert t * (rank + 1) <= row_t
                gathered = flat[batch.utt_time_index[slot]][:t]
                np.testing.assert_allclose(gathered, feats[key])
                assert batch.utt_sequence_length[slot] == t
                assert list(batch.nnet_target[
                    slot, :batch.target_length[slot]]) == list(labs[key])
                # keys is slot-indexed alongside the per-utterance arrays
                assert batch.keys[slot] == key
                seen.append(key)
        # reset marks = number of packed segments in the batch
        assert int(batch.reset_mask.sum()) == sum(len(r) for r in rows)
    assert sorted(seen) == sorted(m.key for m in metas)


def test_tiered_gather_is_opt_in(monkeypatch):
    """The tiered CTC gather must stay OFF unless asked (env or config) —
    the simpler full-width view is the shipped default.  The gate is resolved
    where the gather is built (train/graph.ctc_tiered_enabled), with no
    batcher-side config mutation."""
    from lstm_ctc_tpu.train.graph import ctc_tiered_enabled

    monkeypatch.delenv("LSTM_CTC_TPU_CTC_TIERED", raising=False)
    assert ctc_tiered_enabled({}) is False
    assert ctc_tiered_enabled({"ctc_tiered_slots": True}) is True
    assert ctc_tiered_enabled({"ctc_tiered_slots": False}) is False
    monkeypatch.setenv("LSTM_CTC_TPU_CTC_TIERED", "1")
    assert ctc_tiered_enabled({}) is True
    monkeypatch.setenv("LSTM_CTC_TPU_CTC_TIERED", "0")
    assert ctc_tiered_enabled({"ctc_tiered_slots": True}) is False


def test_tiered_ctc_gather_matches_full_width():
    """compute_losses with ctc_tiered_slots (rank-tier static widths)
    must produce the same loss and gradients as the full-width gather on
    batcher-produced packed batches."""
    from lstm_ctc_tpu.data.pipeline import BucketedBatcher
    from lstm_ctc_tpu.data.records import RecordMeta

    rng = np.random.RandomState(13)
    lens = [30, 17, 9, 28, 12, 7, 21, 3, 27, 14, 31, 5]
    metas = [RecordMeta("utt%02d" % i, t, 6, True, "mem", i)
             for i, t in enumerate(lens)]
    feats = {m.key: rng.randn(m.num_rows, 6).astype(np.float32)
             for m in metas}
    labs = {m.key: rng.randint(0, 4, 2 + i % 4).astype(np.int32)
            for i, m in enumerate(metas)}

    class FakeLoader:
        def load(self, meta):
            return meta.key, feats[meta.key], labs[meta.key]

        def close(self):
            pass

    b = BucketedBatcher(metas, batch_size=2, pack_factor=3,
                        time_quant=8, label_quant=4,
                        label_lengths=[len(labs[m.key]) for m in metas])
    params, net_state = init_model(jax.random.PRNGKey(4), CONFIG)
    plan = b.batch_plan(shuffle=True, seed=1)

    for bucket_idx, rows in plan:
        batch_obj = b.assemble(bucket_idx, rows, FakeLoader())
        batch = {
            "nnet_input": jnp.asarray(batch_obj.nnet_input),
            "sequence_length": jnp.asarray(batch_obj.sequence_length),
            "nnet_target": jnp.asarray(batch_obj.nnet_target),
            "target_length": jnp.asarray(batch_obj.target_length),
            "reset_mask": jnp.asarray(batch_obj.reset_mask),
            "utt_time_index": jnp.asarray(batch_obj.utt_time_index),
            "utt_sequence_length":
                jnp.asarray(batch_obj.utt_sequence_length),
        }

        def loss_of(p, tiered):
            cfg = dict(CONFIG, ctc_tiered_slots=tiered)
            metrics, _, _ = compute_losses(p, net_state, batch, cfg,
                                           train=False)
            return metrics["eval_loss"]

        l_full, g_full = jax.value_and_grad(
            lambda p: loss_of(p, False))(params)
        l_tier, g_tier = jax.value_and_grad(
            lambda p: loss_of(p, True))(params)
        np.testing.assert_allclose(float(l_tier), float(l_full),
                                   rtol=1e-5)
        for (path, a), (_, bb) in zip(
                jax.tree_util.tree_leaves_with_path(g_tier),
                jax.tree_util.tree_leaves_with_path(g_full)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(bb),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=str(path))


def test_undeclared_contract_falls_back_to_flat_gather():
    """A producer with a CONFORMING slot count but a different slot→row
    mapping (utterance-order slots — the layout this file's own tests
    used before the contract existed) must get the layout-agnostic flat
    gather, i.e. the exact unpacked loss, unless the config DECLARES
    the rank-major contract.  Before the gate, such a batch silently
    got the row-batched gather, whose out-of-row rebased indices clip
    into the wrong rows (train/graph.compute_losses)."""
    feats, labels = make_utts(seed=8)
    params, net_state = init_model(jax.random.PRNGKey(3), CONFIG)
    packed = packed_batch(feats, labels)
    # permute slots into utterance order: slot j now holds utterance j.
    # Valid flat indices, but NOT rank-major — e.g. slot 1 holds utt 1,
    # which lives in row 0, while slot % B says row 1.
    reorder = np.asarray(SLOT_OF_UTT)
    shuffled = dict(packed)
    for key in ("utt_time_index", "utt_sequence_length",
                "nnet_target", "target_length"):
        shuffled[key] = packed[key][reorder]
    undeclared = {k: v for k, v in CONFIG.items()
                  if k != "packed_slots_rank_major"}

    def eval_loss(batch, config):
        metrics, _, _ = compute_losses(params, net_state, batch,
                                       config, train=False)
        return float(metrics["eval_loss"])

    want = eval_loss(unpacked_batch(feats, labels), undeclared)
    np.testing.assert_allclose(eval_loss(shuffled, undeclared), want,
                               rtol=1e-5)
    # sanity-check the hazard the gate guards: declaring the contract
    # for this non-conforming layout really does compute a wrong loss
    assert abs(eval_loss(shuffled, CONFIG) - want) > 1e-3
