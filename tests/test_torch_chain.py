"""vacmap_tpu_torch chain DP (plain PyTorch version, CPU) against the JAX
scan ``vacmap_tpu.ops.chain_jax.chain_scores_batch`` on the same inputs.

Tolerance: S within atol 1e-3 (rtol 1e-6) and a predecessor agreement of
at least 0.99, printed.  Both sides compute in f32, but XLA-CPU's and
torch's log/log2 may differ by an ulp, which can flip a near-tie."""

import numpy as np
import pytest
import torch

from vacmap_tpu.ops.chain_jax import chain_scores_batch as jax_chain_scores_batch
from vacmap_tpu.ops.chain_ref import chain_dp
from vacmap_tpu.pipeline.chaining import chain_read
from vacmap_tpu_torch.ops.chain import (
    MAX_ANCHORS,
    MAX_N, TorchChainBackend, chain_results, chain_scores_batch,
    chain_scores_batch_ref, prepare_batch, to_device,
)
from tests.test_chain import chainy_anchors, random_anchors

VARIANTS = ["global", "global_nocov", "refund", "fine", "mismatch"]
KW = dict(kmersize=15, maxdiff=50, maxgap=1000, skipcost=40.0)


def _anchor_list(rng, kind, variant):
    alist = []
    for _ in range(4):
        if kind == "random":
            a = random_anchors(rng, int(rng.integers(100, 400)))
        else:
            a = chainy_anchors(rng, read_len=int(rng.integers(2000, 6000)),
                               noise=int(rng.integers(5, 30)))
        if variant in ("fine", "mismatch"):
            a = a[np.argsort(a[:, 0] + a[:, 3], kind="stable")]
        alist.append(a)
    return alist


def _both(alist, variant, **kw):
    kw = {**KW, **kw, "variant": variant}
    arrays = prepare_batch(alist, variant, kw["skipcost"], kw["maxdiff"])
    S_j, P_j = jax_chain_scores_batch(*arrays, **kw)
    S_t, P_t = chain_scores_batch_ref(*to_device("cpu", *arrays), **kw)
    return arrays, (np.asarray(S_j), np.asarray(P_j)), (S_t.numpy(), P_t.numpy())


@pytest.mark.parametrize("kind", ["random", "chainy"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_chain_ref_matches_jax(variant, kind):
    rng = np.random.default_rng(100 + VARIANTS.index(variant) + (kind == "chainy") * 10)
    alist = _anchor_list(rng, kind, variant)
    arrays, (S_j, P_j), (S_t, P_t) = _both(alist, variant)
    assert arrays[0].shape[1] in (128, 256, 512)
    valid = np.arange(arrays[0].shape[1])[None, :] < arrays[1][:, None]
    np.testing.assert_allclose(S_t[valid], S_j[valid], atol=1e-3, rtol=1e-6)
    # padded rows: S = 0, P = -1 on both sides
    assert (S_t[~valid] == 0).all() and (P_t[~valid] == -1).all()
    agree = float(np.mean(P_t[valid] == P_j[valid]))
    print(f"chain {variant}/{kind}: P agreement {agree:.6f} "
          f"({int(valid.sum())} anchors)")
    assert agree >= 0.99, agree


def test_chain_ref_g_max_exact_on_chainy():
    rng = np.random.default_rng(7)
    a = chainy_anchors(rng, read_len=2000, noise=10)
    _, (S_j, _), (S_t, _) = _both([a], "global")
    ref = chain_dp(a, 15, 40.0, 50, 1000, "global")
    n = len(a)
    assert int(np.argmax(S_t[0, :n])) == ref.g_max_index
    assert int(np.argmax(S_t[0, :n])) == int(np.argmax(S_j[0, :n]))


def test_chain_ref_padding_irrelevant():
    rng = np.random.default_rng(8)
    a = chainy_anchors(rng, read_len=1500, noise=5)
    b = chainy_anchors(rng, read_len=400, noise=2)
    arrays2 = prepare_batch([a, b], "global", 40.0, 50)
    arrays1 = prepare_batch([b], "global", 40.0, 50)
    S2, P2 = chain_scores_batch_ref(*to_device("cpu", *arrays2), **KW)
    S1, P1 = chain_scores_batch_ref(*to_device("cpu", *arrays1), **KW)
    n = len(b)
    np.testing.assert_array_equal(S2[1, :n].numpy(), S1[0, :n].numpy())
    np.testing.assert_array_equal(P2[1, :n].numpy(), P1[0, :n].numpy())


def test_chain_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(9)
    arrays = prepare_batch([random_anchors(rng, 90)], "global", 40.0, 50)
    x = to_device("cpu", *arrays)
    before = chain_scores_batch.launches
    S, P = chain_scores_batch(*x, **KW)
    S0, P0 = chain_scores_batch_ref(*x, **KW)
    assert torch.equal(S, S0) and torch.equal(P, P0)
    assert chain_scores_batch.launches == before  # no kernel launched


def test_torch_backend_in_pipeline():
    rng = np.random.default_rng(10)
    a = chainy_anchors(rng, read_len=3000, noise=15)
    gc_dev = chain_read(
        a, 3000, kmersize=15, skipcost=40.0, maxdiff=50, accept_score=60.0,
        chain_backend=TorchChainBackend("cpu"),
    )
    gc_host = chain_read(
        a, 3000, kmersize=15, skipcost=40.0, maxdiff=50, accept_score=60.0
    )
    assert gc_dev is not None and gc_host is not None
    assert gc_dev.mapq == gc_host.mapq
    assert abs(gc_dev.score - gc_host.score) < 0.01
    assert len(gc_dev.paths) == len(gc_host.paths)
    for p_dev, p_host in zip(gc_dev.paths, gc_host.paths):
        np.testing.assert_array_equal(p_dev, p_host)


def test_torch_backend_hands_large_coordinates_to_host():
    rng = np.random.default_rng(11)
    a = chainy_anchors(rng, read_len=1000, noise=3)
    be = TorchChainBackend("cpu")
    assert be(a, "global", 15, 40.0, 50, 1000) is not None
    a64 = a.copy()
    a64[:, 1] += 2**31
    assert be(a64, "global", 15, 40.0, 50, 1000) is None
    # more anchors than the per-call backend takes (the reference's
    # 65,536), and the refund variant above chain_dp.cu's shared-memory
    # limit (its ledger exists only there)
    big = np.zeros((MAX_ANCHORS + 1, 4), np.int64)
    assert be(big, "global", 15, 40.0, 50, 1000) is None
    assert be(big[: MAX_N + 1], "refund", 15, 40.0, 50, 1000) is None


def test_chain_results_padding_changes_nothing():
    rng = np.random.default_rng(12)
    alist = [chainy_anchors(rng, read_len=int(rng.integers(300, 900)), noise=4)
             for _ in range(3)]
    args = ("global", 15, 40.0, 50, 1000)
    plain = chain_results("cpu", alist, *args)
    padded = chain_results("cpu", alist, *args, pad_N=1024, pad_B=8)
    for a, r0, r1 in zip(alist, plain, padded):
        assert len(r0.S) == len(r1.S) == len(a)
        assert r0.g_max_index == r1.g_max_index
        np.testing.assert_array_equal(r0.P, r1.P)
        np.testing.assert_array_equal(r0.S, r1.S)
