"""vacmap_tpu_torch CUDA kernels against their plain PyTorch versions on
the card.  These need an NVIDIA Hopper card and nvcc, so they skip
elsewhere; run them on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

(``--noconftest``: tests/conftest.py imports jax, which the port does not
need on the card's machine.  For the same reason this file imports no
other test module: its anchor generators mirror tests/test_chain.py's.)
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


def random_anchors(rng, n, read_len=2000, ref_len=100_000):
    r = np.sort(rng.integers(0, read_len, n))
    y = rng.integers(0, ref_len, n)
    s = rng.choice([-1, 1], n)
    l = rng.integers(9, 21, n)
    return np.stack([r, y, s, l], axis=1).astype(np.int64)


def chainy_anchors(rng, read_len=3000, step=40, diag=5000, noise=10):
    """Mostly-colinear anchors with jitter plus some random noise anchors."""
    r = np.arange(0, read_len - 20, step)
    y = r + diag + rng.integers(-3, 4, len(r))
    a = np.stack([r, y, np.ones(len(r), np.int64), np.full(len(r), 15)], axis=1)
    out = np.concatenate([a, random_anchors(rng, noise, read_len)])
    return out[np.argsort(out[:, 0], kind="stable")]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels build with nvcc for sm_90a)")
    return torch.device("cuda:0")


def _pairs(rng, n, lo, hi, err=0.06, random_frac=0.1):
    out = []
    while len(out) < n:
        L = int(rng.integers(lo, hi + 1))
        t = rng.integers(0, 4, L).astype(np.uint8)
        q = t.copy()
        m = rng.random(L) < err
        q[m] = rng.integers(0, 4, int(m.sum()))
        if rng.random() < 0.3:
            p = int(rng.integers(0, L))
            q = np.concatenate([q[:p], rng.integers(0, 4, int(rng.integers(1, 80))).astype(np.uint8), q[p:]])
        if rng.random() < random_frac:  # unrelated pair: band escalations
            q = rng.integers(0, 4, max(1, L + int(rng.integers(-40, 40)))).astype(np.uint8)
        if len(q) <= hi:
            out.append((t, q))
    return out


def _planes(pairs, N):
    B = len(pairs)
    tT = np.full((B, N), 4, np.uint8)
    tQ = np.full((B, N), 4, np.uint8)
    lens = np.zeros((B, 2), np.int32)
    for b, (t, q) in enumerate(pairs):
        tT[b, : len(t)] = t
        tQ[b, : len(q)] = q
        lens[b] = (len(t), len(q))
    return tT, tQ, lens


@pytest.mark.parametrize("variant", ["global", "global_nocov", "refund", "fine", "mismatch"])
def test_chain_kernel_matches_plain(dev, variant):
    from vacmap_tpu_torch.ops.chain import (
        chain_scores_batch, chain_scores_batch_ref, prepare_batch, to_device,
    )

    rng = np.random.default_rng(31)
    alist = [random_anchors(rng, int(rng.integers(200, 900))) if k % 2
             else chainy_anchors(rng, read_len=20000, noise=40) for k in range(6)]
    if variant in ("fine", "mismatch"):
        alist = [a[np.argsort(a[:, 0] + a[:, 3], kind="stable")] for a in alist]
    arrays = prepare_batch(alist, variant, 40.0, 50)
    x = to_device(dev, *arrays)
    kw = dict(kmersize=15, maxdiff=50, maxgap=1000, skipcost=40.0, variant=variant)
    before = chain_scores_batch.launches
    S, P = chain_scores_batch(*x, **kw)
    torch.cuda.synchronize()
    assert chain_scores_batch.launches == before + 1
    S0, P0 = chain_scores_batch_ref(*x, **kw)
    valid = np.arange(arrays[0].shape[1])[None, :] < arrays[1][:, None]
    S, P, S0, P0 = (t.cpu().numpy() for t in (S, P, S0, P0))
    np.testing.assert_allclose(S[valid], S0[valid], atol=1e-3, rtol=1e-6)
    assert (S[~valid] == 0).all() and (P[~valid] == -1).all()
    assert np.mean(P[valid] == P0[valid]) >= 0.999


@pytest.mark.parametrize("N", [256, 512])
def test_full_fill_kernel_matches_plain(dev, N):
    from vacmap_tpu_torch.ops.affine_fill import fill_rowruns, fill_rowruns_ref

    rng = np.random.default_rng(32 + N)
    x = [torch.from_numpy(a).to(dev) for a in _planes(_pairs(rng, 96, 1, N), N)]
    got = fill_rowruns(*x)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), fill_rowruns_ref(*x).cpu())


@pytest.mark.parametrize("T", [256, 512])
def test_banded_fill_kernel_matches_plain(dev, T):
    from vacmap_tpu_torch.ops.affine_fill import (
        fill_rowruns_banded, fill_rowruns_banded_ref, make_qshift,
    )

    rng = np.random.default_rng(33 + T)
    pairs = [(t, q) for t, q in _pairs(rng, 160, 1, T - 100) if abs(len(t) - len(q)) <= 95]
    tT, tQ, lens = _planes(pairs, T)
    qs = make_qshift(tQ, lens[:, 0], lens[:, 1], T)
    x = [torch.from_numpy(a).to(dev) for a in (tT, qs, lens)]
    got = fill_rowruns_banded(*x)
    torch.cuda.synchronize()
    want = fill_rowruns_banded_ref(*x).cpu()
    assert torch.equal(got.cpu(), want)


def test_aligner_on_card_matches_host(dev):
    from vacmap_tpu import native
    from vacmap_tpu_torch.ops.affine_fill import TorchFillAligner

    rng = np.random.default_rng(34)
    pairs = _pairs(rng, 400, 1, 700, err=0.05, random_frac=0.0)
    got = TorchFillAligner(device=dev).align_batch(pairs, eqx=True)
    want = native.align2p_batch_native(pairs, eqx=True)
    assert [g.cigar for g in got] == [native.ops_to_cigar(w) for w in want]
