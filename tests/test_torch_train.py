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
    (["--param-shards", "2", "--ckpt", "ck"], "no mid-schedule resume")])
def test_train_rejects_what_is_not_ported(extra, msg, capsys):
    with pytest.raises(SystemExit):
        train.main(ARGS + ["--device", "cpu"] + extra)
    assert msg in capsys.readouterr().err


def test_train_needs_a_gpu_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(ARGS)


SHARD_ARGS = ["--reduced", "--nodes", "4", "--steps", "3", "--seq", "16",
              "--batch-per-node", "2", "--scenario", "uniform",
              "--log-every", "1", "--device", "cpu"]


def test_param_shards_on_host_ranks_give_the_unsharded_losses():
    """--param-shards 2 --host-devices 2: two gloo ranks on the CPU, each
    holding half of the flat state, train the unsharded run's losses."""
    want = train.main(SHARD_ARGS)
    got = train.main(SHARD_ARGS + ["--param-shards", "2",
                                   "--host-devices", "2"],
                     timeout_s=60.0, join_s=240.0)
    assert got["param_shards"] == 2 and got["rank"] == 0
    assert got["events"] == want["events"] and got["waves"] == want["waves"]
    assert got["losses"] == pytest.approx(want["losses"], rel=0, abs=2e-5)
    assert got["mass_rel"] < 1e-4


@pytest.mark.parametrize("extra,msg", [
    (["--scenario", "uniform", "--publish-dir", "pub"],
     "--publish-dir rides the wavefront chunk callback"),
    (["--scenario", "uniform", "--ckpt", "ck"],
     "--param-shards trains through run_sweep(mesh=...), which has no "
     "mid-schedule resume"),
    (["--scenario", "churn"],
     "--param-shards is not supported for dynamic (membership) scenarios"),
    (["--scenario", ""],
     "--param-shards shards the wavefront engine's flat parameter axis"),
    (["--scenario", "uniform", "--host-devices", "1"],
     "--param-shards 2 needs 2 devices")])
def test_param_shards_refusals_keep_their_messages(extra, msg, capsys):
    with pytest.raises(SystemExit):
        train.parse_args(ARGS + ["--device", "cpu", "--param-shards", "2"]
                         + extra)
    assert msg in " ".join(capsys.readouterr().err.split())
