"""vacmap_tpu_torch.entry on the CPU: entry() against the JAX package's
__graft_entry__.entry() on the same example batch, dryrun_multichip over
four CPU devices, and no CPU fallback when cards are asked for."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vacmap_tpu_torch import entry as port_entry
from vacmap_tpu_torch.device import DeviceKernelError

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def reference_entry():
    sys.path.insert(0, str(REPO))
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    S, P = fn(*args)
    return [np.asarray(a) for a in args], np.asarray(S), np.asarray(P)


def test_entry_matches_the_jax_entry(reference_entry):
    """The same example batch, and the chain DP's S within 1e-4 and P
    equal (largest S difference seen: 0)."""
    ref_args, S0, P0 = reference_entry
    fn, args = port_entry.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    for a, b in zip(args, ref_args):
        np.testing.assert_array_equal(a.numpy(), b)
    S, P = fn(*args)
    valid = np.arange(S0.shape[1])[None, :] < ref_args[1][:, None]
    err = float(np.abs(S.numpy() - S0)[valid].max())
    print(f"entry: max|dS| {err:.3g}")
    assert err <= 1e-4
    np.testing.assert_array_equal(P.numpy(), P0)


def test_dryrun_multichip_on_four_cpu_devices():
    port_entry.dryrun_multichip(4, device="cpu")


def test_cards_asked_for_and_missing_raise():
    if torch.cuda.device_count() >= 2:
        pytest.skip("two cards are visible")
    with pytest.raises(DeviceKernelError):
        port_entry.dryrun_multichip(2)
    if torch.cuda.device_count() == 0:
        with pytest.raises(DeviceKernelError):
            port_entry.entry()
