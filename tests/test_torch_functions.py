"""The broadcast and object helpers of the port (``horovod_tpu_torch/
functions.py``, ``metric_average``) at worlds 1 and 2.

World 2 runs as two gloo processes (root: the last rank): a state_dict,
a tensor list and named parameters take the root's values in place; an
optimizer that never stepped takes the stepped root's moments, step
counts (kept on the CPU, as torch keeps them) and learning rate; a
DistributedOptimizer takes the root's microstep count and accumulator;
objects travel pickled. World 1 in process holds the port against the
reference's helpers, which run without an engine there."""

import json

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.jax import functions as ref_functions
from horovod_tpu.jax import metric_average as ref_metric_average

import torch_dist_cases as cases


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return cases.spawn(2, tmp_path_factory.mktemp("functions2"), "functions",
                       timeout=120)


def test_parameters_take_the_roots_values(world2):
    root = world2[-1]
    for out in world2:
        for key in [k for k in root if k.startswith(("sd/", "list/",
                                                     "named/"))]:
            np.testing.assert_array_equal(out[key], root[key], err_msg=key)
    np.testing.assert_array_equal(root["list/0"], np.full((2, 2), 1.0))
    np.testing.assert_array_equal(root["list/1"], np.arange(3) + 1)
    np.testing.assert_array_equal(root["named/weight"], np.ones((2, 2)))


def test_optimizer_state_takes_the_roots(world2):
    """Rank 0 never stepped; after the broadcast it holds the root's two
    AdamW steps, its moments and its learning rate."""
    root = world2[-1]
    keys = [k for k in root if k.startswith("opt/")]
    assert "opt/0/exp_avg" in keys and "opt/0/step" in keys
    for out in world2:
        assert sorted(k for k in out if k.startswith("opt/")) == sorted(keys)
        for key in keys:
            np.testing.assert_array_equal(out[key], root[key], err_msg=key)
    assert float(root["opt/lr"]) == pytest.approx(0.2)
    assert float(root["opt/0/step"]) == 2.0 and bool(root["opt/0/step_on_cpu"])


def test_distributed_optimizer_state_takes_the_roots(world2):
    for out in world2:
        assert int(out["dopt/count"]) == 1
        np.testing.assert_array_equal(out["dopt/accum0"], np.ones((2, 2)))


def test_objects_and_metric_average(world2):
    for out in world2:
        assert json.loads(str(out["object"])) == {"rank": 1,
                                                  "tags": ["a", "b"]}
        assert json.loads(str(out["gathered"])) == ["x", "xx"]
        np.testing.assert_allclose(out["metric_average"], 1.5)


def test_world1_matches_the_reference_helpers():
    """At world 1 every helper leaves its input as it is, as the
    reference's do."""
    obj = {"a": [1, 2], "b": "c"}
    params = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    want_params = ref_functions.broadcast_parameters(params)
    hvd.init(device="cpu")
    try:
        assert hvd.broadcast_object(obj) == ref_functions.broadcast_object(obj)
        assert hvd.allgather_object(obj) == \
            ref_functions.allgather_object(obj)
        sd = {"w": torch.tensor(params["w"])}
        assert hvd.broadcast_parameters(sd) is sd
        np.testing.assert_array_equal(sd["w"].numpy(),
                                      np.asarray(want_params["w"]))
        np.testing.assert_allclose(
            hvd.metric_average(3.5).numpy(),
            np.asarray(ref_metric_average(3.5)))
        model = torch.nn.Linear(2, 2)
        opt = torch.optim.SGD(model.parameters(), lr=0.3, momentum=0.9)
        model(torch.ones(1, 2)).sum().backward()
        opt.step()
        before = opt.state_dict()
        hvd.broadcast_optimizer_state(opt)
        after = opt.state_dict()
        assert after["param_groups"] == before["param_groups"]
        for i, st in before["state"].items():
            torch.testing.assert_close(after["state"][i]["momentum_buffer"],
                                       st["momentum_buffer"])
    finally:
        hvd.shutdown()
