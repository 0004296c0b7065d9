"""The serving plane's compute against the reference: make_tp_lm_step at
gloo worlds 1, 2 and 4 over ``model`` against the reference's on a JAX CPU
mesh whose ``model`` axis has the same size (fp32 and the int8 activation
wire), the weights carried across bit-equal; a ServingLoop on the group's
first rank while the others follow; and make_rnn_lm_step (states, greedy
tokens) against the reference's numpy, with its cached + speculative
decode token-identical to recompute."""

import json

import numpy as np
import pytest

import torch_dist_cases as cases

FP32 = dict(rtol=1e-5, atol=1e-6)
SIZES = {"small": cases.SERVE_TP_DIMS,
         "hvd_serve": dict(vocab=256, hidden=64, mlp_dim=256, layers=2)}


def reference_weights(dims, seed=0):
    """The reference make_tp_lm_step's weights, drawn as it draws them
    (executor.py:607-614)."""
    import jax.numpy as jnp
    rng = np.random.RandomState(seed)
    embed = jnp.asarray(rng.randn(dims["vocab"], dims["hidden"]) * 0.05,
                        jnp.float32)
    ws = []
    for _ in range(dims["layers"]):
        ws.append(jnp.asarray(rng.randn(dims["hidden"], dims["mlp_dim"])
                              * 0.05, jnp.float32))
        ws.append(jnp.asarray(rng.randn(dims["mlp_dim"], dims["hidden"])
                              * 0.05, jnp.float32))
    return embed, ws


def reference_tp(dims, world, wire, tokens, lengths):
    """(last-position logits from the reference's full [B, L, vocab]
    computation, the reference step_fn's greedy tokens) on a CPU mesh
    with model = world: the reference's ``local`` (executor.py:616-632)
    returning the logits it takes the argmax of."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.jax.compression import Compression
    from horovod_tpu.parallel import mesh as mesh_lib
    from horovod_tpu.parallel.tp import tp_mlp_inference
    from horovod_tpu.serve.executor import make_tp_lm_step
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(data=1, model=world),
                               jax.devices()[:world])
    comp = Compression.int8 if wire == "int8" else None
    embed, ws = reference_weights(dims)

    def ln(x):
        mu = jnp.mean(x, axis=-1, keepdims=True)
        var = jnp.var(x, axis=-1, keepdims=True)
        return (x - mu) * jax.lax.rsqrt(var + 1e-6)

    def local(tokens, lengths, embed, *ws):
        x = embed[tokens]
        for li in range(dims["layers"]):
            x = x + tp_mlp_inference(ln(x), ws[2 * li], ws[2 * li + 1],
                                     activation=jnp.tanh, axis="model",
                                     compression=comp)
        logits = jnp.einsum("bld,vd->blv", ln(x), embed)
        idx = jnp.clip(lengths - 1, 0, tokens.shape[1] - 1)
        return jnp.take_along_axis(logits, idx[:, None, None],
                                   axis=1)[:, 0]

    specs = [P(None, "model"), P("model", None)] * dims["layers"]
    fn = jax.jit(jax.shard_map(local, mesh=mesh,
                               in_specs=(P(), P(), P(), *specs),
                               out_specs=P(), check_vma=False))
    logits = np.asarray(fn(jnp.asarray(tokens), jnp.asarray(lengths),
                           embed, *ws))
    step, info = make_tp_lm_step(mesh, compression=wire, **dims)
    assert info["tp_world"] == world
    return logits, step(tokens, lengths)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The port's serve_tp job at every (world, size), spawned once."""
    out = {}
    for world in (1, 2, 4):
        for size, dims in SIZES.items():
            d = tmp_path_factory.mktemp(f"tp{world}{size}")
            out[world, size] = cases.spawn(
                world, d, "serve_tp", (dims,), timeout=300,
                mesh={"data": 1, "model": world})
    return out


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("world", [1, 2, 4])
def test_tp_lm_weights_carried_across_bit_equal(port_runs, world, size):
    from horovod_tpu_torch.models.convert import tp_lm_params_from_numpy
    from horovod_tpu_torch.serve.executor import tp_lm_weights
    dims = SIZES[size]
    embed, ws = reference_weights(dims)
    p_embed, p_ws = tp_lm_weights(seed=0, **dims)
    np.testing.assert_array_equal(p_embed, np.asarray(embed))
    for got, want in zip(p_ws, ws):
        np.testing.assert_array_equal(got, np.asarray(want))
    for rank, res in enumerate(port_runs[world, size]):
        want = tp_lm_params_from_numpy(np.asarray(embed),
                                       [np.asarray(w) for w in ws], rank,
                                       world)
        for wire in ("none", "int8"):
            keys = sorted(k.split("|")[2] for k in res
                          if k.startswith(f"{wire}|param|"))
            assert keys == sorted(want)
            for k, v in want.items():
                np.testing.assert_array_equal(
                    res[f"{wire}|param|{k}"], v.numpy(),
                    err_msg=f"{k} rank {rank}")


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("world", [1, 2, 4])
def test_tp_lm_fp32_matches_reference(port_runs, world, size):
    """fp32 wire: greedy tokens equal to the reference step's, the
    last-position logits (gathered before the head) within rtol 1e-5 /
    atol 1e-6 of the reference's full computation; the same for the
    whole model on one device (``axis=None``)."""
    dims = SIZES[size]
    tokens, lengths = cases.serve_inputs(dims["vocab"])
    logits, toks = reference_tp(dims, world, "none", tokens, lengths)
    lead = port_runs[world, size][0]
    np.testing.assert_allclose(lead["none|logits"], logits, **FP32)
    np.testing.assert_array_equal(lead["none|tokens"], toks)
    np.testing.assert_allclose(lead["one|logits"], logits, **FP32)
    np.testing.assert_array_equal(lead["one|tokens"], toks)
    for rank, res in enumerate(port_runs[world, size][1:], 1):
        assert int(res["none|followed"]) == 7, rank  # logits, tokens, 5


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("world", [1, 2, 4])
def test_tp_lm_int8_matches_reference(port_runs, world, size):
    """int8 wire: logits elements outside rtol 1e-5 / atol 1e-6 of the
    reference's int8 logits no more than INT8_FLIP_RATE of them (a value
    a rounding apart may land on the next int8 level, C7); at the
    reference test's size the tokens are equal, and they agree with the
    fp32 wire's there. At a world of 1 the whole model on one device
    without a group (``axis=None``) gives the same bits as the model axis
    of one."""
    dims = SIZES[size]
    tokens, lengths = cases.serve_inputs(dims["vocab"])
    logits, toks = reference_tp(dims, world, "int8", tokens, lengths)
    lead = port_runs[world, size][0]
    bad, total, worst = cases.int8_mismatches(
        {"l": lead["int8|logits"]}, {"l": logits}, FP32)
    assert bad <= max(2, cases.INT8_FLIP_RATE * total), (bad, worst)
    info = json.loads(str(lead["int8|info"]))
    assert info["compression"] == "int8" and info["tp_world"] == world
    if world == 1:
        np.testing.assert_array_equal(lead["one_int8|logits"],
                                      lead["int8|logits"])
        np.testing.assert_array_equal(lead["one_int8|tokens"],
                                      lead["int8|tokens"])
    if size == "small":
        np.testing.assert_array_equal(lead["int8|tokens"], toks)
        np.testing.assert_array_equal(lead["int8|tokens"],
                                      lead["none|tokens"])


@pytest.mark.parametrize("world", [2, 4])
def test_tp_lm_serving_loop_leader_and_followers(tmp_path, world):
    """The group's first rank serves 16 requests through a ServingLoop
    over the int8 step while the others follow: every request returns ok
    with the tokens of its prompt decoded alone, and every follower exits
    after stop()."""
    res = cases.spawn(world, tmp_path, "serve_loop",
                      (cases.SERVE_TP_DIMS, "int8"), timeout=300,
                      mesh={"data": 1, "model": world})
    lead = res[0]
    assert list(lead["status"]) == ["ok"] * 16
    np.testing.assert_array_equal(lead["tokens"], lead["alone"])
    followed = {int(r["followed"]) for r in res[1:]}
    assert len(followed) == 1 and followed.pop() >= 16 * 4 // 8


def test_tp_lm_leader_failure_mid_step_stops_the_group(tmp_path):
    """A step that fails on the group's first rank after its broadcasts
    leaves the followers inside the step's reductions: the leader's loop
    stops for good on HorovodInternalError (the requests it carried and
    those queued fail, later submits are refused, nothing more is sent),
    and the followers fail out of follow() instead of lining a later
    broadcast up against a reduction."""
    res = cases.spawn(2, tmp_path, "serve_fault", (cases.SERVE_TP_DIMS,),
                      timeout=300, mesh={"data": 1, "model": 2})
    lead, follower = res
    assert str(lead["fatal"]) == "HorovodInternalError"
    assert bool(lead["stopped"]) and bool(lead["refused"])
    assert "planted fault" in str(lead["closed"])
    assert list(lead["status"]) == ["failed"] * 4
    # the first step ran (one token each for the batch of 2), the second
    # failed; the queued two never ran
    assert list(lead["generated"]) == [1, 1, 0, 0]
    assert int(follower["followed"]) == 0  # follow() raised, no return
    assert str(follower["error"]) == "HorovodInternalError"


@pytest.mark.parametrize("world", [1, 2, 4])
def test_int8_probe_bounds_the_wire_against_reference(world):
    """chip_smoke.serve_int8_probe at the reference test's size on the
    CPU: the reference's int8 logits at a model axis of ``world`` lie
    within the bound the probe puts on them from the fp32 partial sums
    of ``world`` ranks; at a world of 1 the probe also runs the port's
    wire (``axis=None``) layer by layer within the codec's bound, and its
    logits are the int8 step's bits."""
    import chip_smoke
    from horovod_tpu_torch.serve.executor import make_tp_lm_step
    dims = cases.SERVE_TP_DIMS
    tokens, lengths = cases.serve_inputs(dims["vocab"])
    ref_fp32, _ = reference_tp(dims, world, "none", tokens, lengths)
    ref_int8, _ = reference_tp(dims, world, "int8", tokens, lengths)
    fp32, _ = make_tp_lm_step(device="cpu", axis=None, **dims)
    _, bound, ratio, _ = chip_smoke.serve_int8_probe(fp32.model, tokens,
                                                     lengths, world=world)
    assert ratio is None
    err = np.abs(ref_int8 - ref_fp32).max(-1)
    assert (err <= bound.numpy()).all(), (err, bound)
    assert (err > 0).any()  # the wire did move the logits
    if world == 1:
        int8, _ = make_tp_lm_step(device="cpu", axis=None,
                                  compression="int8", **dims)
        logits, bound, ratio, _ = chip_smoke.serve_int8_probe(
            int8.model, tokens, lengths, wire_axis=None)
        assert 0 < ratio <= 1
        np.testing.assert_array_equal(logits.numpy(),
                                      int8.logits(tokens, lengths).numpy())
        assert (np.abs(logits.numpy() - ref_fp32).max(-1) <=
                bound.numpy()).all()


def test_int8_probe_catches_a_codec_that_truncates(monkeypatch):
    """The mutation case: a block quantizer that truncates instead of
    rounding to the nearest level moves elements by up to a whole level
    per round trip, outside the codec's bound the probe holds the wire
    to."""
    import torch
    import chip_smoke
    from horovod_tpu_torch.parallel import collectives
    from horovod_tpu_torch.serve.executor import make_tp_lm_step

    def truncating(rows, block_size):
        r, c = rows.shape
        blocks = rows.float().reshape(r, c // block_size, block_size)
        scale = blocks.abs().amax(-1) / 127.0
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        q = torch.trunc(blocks / safe[..., None])
        return q.to(torch.int8).reshape(r, c), scale
    dims = cases.SERVE_TP_DIMS
    tokens, lengths = cases.serve_inputs(dims["vocab"])
    int8, _ = make_tp_lm_step(device="cpu", axis=None, compression="int8",
                              **dims)
    monkeypatch.setattr(collectives, "block_quantize_rows", truncating)
    with pytest.raises(AssertionError, match="codec's bound"):
        chip_smoke.serve_int8_probe(int8.model, tokens, lengths,
                                    wire_axis=None)


def test_activation_wire_report_matches_reference():
    from horovod_tpu.serve.executor import activation_wire_report as ref
    from horovod_tpu_torch.serve.executor import activation_wire_report
    for args in ((256, 4, 8), (768, 12, 4), (64, 2, 1)):
        assert activation_wire_report(*args) == ref(*args)


def test_make_tp_lm_step_needs_init_or_axis_none():
    """Over an axis the step needs the job's groups; ``axis=None`` runs
    without them, and the entry point refuses the CPU unless asked."""
    import torch
    from horovod_tpu_torch.serve.executor import make_tp_lm_step
    with pytest.raises(ValueError, match="initialized"):
        make_tp_lm_step(device="cpu")
    step, info = make_tp_lm_step(device="cpu", axis=None)
    assert info["tp_world"] == 1 and step.leader
    assert step(*cases.serve_inputs(256, rows=2)).shape == (2,)
    step.stop()  # world 1: nothing to stop
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_tp_lm_step(axis=None)


# ---------------------------------------------------------------------------
# the fast path's recurrent LM

RNN_PROMPTS = [[1, 2, 3], [5, 5, 5, 5, 5], [250, 7], list(range(40)),
               [9] * 17, [0]]


def rnn_batch(prompts):
    width = max(len(p) for p in prompts)
    tokens = np.zeros((len(prompts), width), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    return tokens, np.array([len(p) for p in prompts], np.int64)


@pytest.mark.parametrize("hidden,vocab", [(64, 256), (192, 256)])
def test_rnn_lm_matches_reference(hidden, vocab):
    """The port's cached step and draft against the reference's numpy
    from the zero state and from a mid-sequence checkpoint: states within
    rtol 1e-5 / atol 1e-6, greedy predictions equal; the weights carried
    across bit-equal."""
    from horovod_tpu.serve.executor import make_rnn_lm_step as ref_make
    from horovod_tpu_torch.serve.executor import make_rnn_lm_step
    _, r_cached, r_draft, _ = ref_make(hidden=hidden, vocab=vocab)
    _, cached, draft, info = make_rnn_lm_step(hidden=hidden, vocab=vocab,
                                              device="cpu")
    assert info["device"] == "cpu"
    for mine, ref in ((cached, r_cached), (draft, r_draft)):
        np.testing.assert_array_equal(mine.embed.numpy(), ref.embed)
        np.testing.assert_array_equal(mine.w.numpy(), ref.w)
        tokens, upto = rnn_batch(RNN_PROMPTS)
        b = len(RNN_PROMPTS)
        start = np.zeros(b, np.int64)
        p_want, s_want = ref.advance(tokens, upto, ref.init_state(b), start)
        p_got, s_got = mine.advance(tokens, upto, mine.init_state(b), start)
        np.testing.assert_array_equal(p_got, p_want)
        np.testing.assert_allclose(s_got, s_want, **FP32)
        # resume every row from its checkpoint after 1 position
        mid = np.ones(b, np.int64)
        p_want, s_want = ref.advance(tokens, upto, s_want[:, 0], mid)
        p_got, s_got = mine.advance(tokens, upto, s_got[:, 0], mid)
        for i, n in enumerate(upto - 1):
            np.testing.assert_array_equal(p_got[i, :n], p_want[i, :n])
            np.testing.assert_allclose(s_got[i, :n], s_want[i, :n], **FP32)


def test_rnn_lm_step_fn_matches_reference():
    """The recompute step_fn's greedy tokens equal the reference's on the
    reference test's prompts."""
    from horovod_tpu.serve.executor import make_rnn_lm_step as ref_make
    from horovod_tpu_torch.serve.executor import make_rnn_lm_step
    ref_step = ref_make(hidden=64, vocab=256)[0]
    step = make_rnn_lm_step(hidden=64, vocab=256, device="cpu")[0]
    tokens, lengths = rnn_batch(RNN_PROMPTS)
    lengths = lengths.astype(np.int32)
    np.testing.assert_array_equal(step(tokens, lengths),
                                  ref_step(tokens, lengths))


def test_rnn_advance_rows_independent_of_batch():
    """A row's predictions and states are the same bits whatever else the
    batch holds (the products run on fixed 8-row tiles): alone, among
    others, and beyond the first tile."""
    from horovod_tpu_torch.serve.executor import make_rnn_lm_step
    _, cached, _, _ = make_rnn_lm_step(hidden=64, vocab=256, device="cpu")
    prompts = RNN_PROMPTS * 2 + [[3, 1, 4, 1, 5]]
    tokens, upto = rnn_batch(prompts)
    b = len(prompts)
    p_all, s_all = cached.advance(tokens, upto, cached.init_state(b),
                                  np.zeros(b, np.int64))
    for i in (0, 3, b - 1):
        p, s = cached.advance(tokens[i:i + 1], upto[i:i + 1],
                              cached.init_state(1), np.zeros(1, np.int64))
        n = int(upto[i])
        np.testing.assert_array_equal(p[0, :n], p_all[i, :n])
        np.testing.assert_array_equal(s[0, :n], s_all[i, :n])
