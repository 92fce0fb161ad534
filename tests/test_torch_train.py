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
from test_torch_engine import two_torch_threads  # noqa: F401

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


@pytest.mark.parametrize("extra,msg", [
    (["--scenario", "churn", "--ckpt", "ck"],
     "--ckpt resume is not supported for dynamic"),
    (["--scenario", "", "--publish-dir", "pub"], "(pass --scenario)"),
    (["--scenario", "root_failover", "--param-shards", "2"],
     "--param-shards is not supported for dynamic"),
    (["--loss-prob", "0.1"], "--loss-prob models loss"),
    (["--param-shards", "2"], "not ported yet")])
def test_train_rejects_what_is_not_ported(extra, msg, capsys):
    with pytest.raises(SystemExit):
        train.main(ARGS + ["--device", "cpu"] + extra)
    assert msg in capsys.readouterr().err


def test_train_needs_a_gpu_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(ARGS)
