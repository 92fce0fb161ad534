"""The port's train driver against the JAX driver, reduced, on the CPU.

Weights and per-event batches come from different generators in the
two packages, so losses are only required to be finite and falling;
the realized schedule (events, virtual time, delivered fraction) must be
the JAX driver's exactly.
"""
import math

import pytest
import torch

from repro.launch import train as jax_train
from repro_torch.launch import train

ARGS = ["--reduced", "--nodes", "4", "--steps", "3", "--seq", "16",
        "--batch-per-node", "2", "--scenario", "straggler", "--log-every",
        "1"]


def test_train_matches_jax_driver():
    want = jax_train.main(ARGS)
    got = train.main(ARGS + ["--device", "cpu"])
    assert got["mode"] == "async" and got["scenario"] == "straggler"
    for key in ("events", "vtime", "send_ok"):
        assert got[key] == want[key], key
    assert len(got["losses"]) == len(want["losses"]) == 4
    assert all(math.isfinite(v) for v in got["losses"])
    assert got["losses"][-1] < got["losses"][0]
    assert got["mass_rel"] < 1e-4            # Lemma 3 after training


def test_train_plain_backend_matches_kernel_backend_on_cpu():
    a = train.main(ARGS + ["--device", "cpu", "--impl", "kernel"])
    b = train.main(ARGS + ["--device", "cpu", "--impl", "plain"])
    assert a["losses"] == pytest.approx(b["losses"], rel=1e-5)


@pytest.mark.parametrize("extra", [
    ["--scenario", ""], ["--ckpt", "ck"], ["--publish-dir", "pub"],
    ["--param-shards", "2"], ["--scenario", "churn"]])
def test_train_rejects_what_is_not_ported(extra, capsys):
    with pytest.raises(SystemExit):
        train.main(ARGS + ["--device", "cpu"] + extra)
    assert "not ported yet" in capsys.readouterr().err


def test_train_needs_a_gpu_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(ARGS)
