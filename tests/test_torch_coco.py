"""The port's CPN COCO detector (``models/cpn_coco.py``, the COCO losses,
``train/train_coco.py``, ``bridge.cpn_coco_from_jax``/``cpn_coco_to_jax``)
against the JAX package on the same weights and inputs, at the tiny size
(``cpn_layers=(1, 1, 1, 1)``, 64x64 frames), on the CPU."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from contextaware_poseformer_tpu.models import convert as jconvert
from contextaware_poseformer_tpu.models.cpn_coco import CPNCoco as JCPNCoco
from contextaware_poseformer_tpu.train import losses as jlosses
from contextaware_poseformer_tpu.train import train_coco as jtrain_coco
from contextaware_poseformer_tpu_torch.data import pipeline
from contextaware_poseformer_tpu_torch.models import bridge, convert
from contextaware_poseformer_tpu_torch.train import losses, train_coco

import torch_oracle  # noqa: E402

HEAD_RTOL = 1e-4  # max |port - JAX| over the RMS of JAX's map
STATS_RTOL = 1e-5
LOSS_RTOL = 1e-4
# Adam fed JAX's gradient: relative L2 of the parameter updates over the
# whole tree, and over each tensor, where one fp32 ulp of a BN scale near 1
# that rounds the other way is 5e-4 of a 2.5e-4 step
UPDATE_RTOL = 1e-4
UPDATE_LEAF_RTOL = 1e-3
# the gradient on the same weights and batch: JAX's BN takes its batch
# variance as E[x^2] - E[x]^2 in fp32, whose cancellation sets the noise
# (JAX's fp32 gradient lies ~4e-3 from the port's fp64 one, the port's
# fp32 gradient ~6e-5: ``test_three_adam_steps...`` prints both)
GRAD_RTOL = 1e-2
GRAD_LEAF_RTOL = 5e-2
PORT_FP64_RTOL = 1e-3
# a leaf whose reference gradient RMS is below this share of the tree's
# vanishes in exact arithmetic: a BN bias whose output reaches only
# train-mode BNs through linear maps (the globalNet upsamples' BNs)
VANISHING = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def variables():
    """Random weights and BN statistics as the reference's torch state
    dict gives them (``torch_oracle``), converted by the port's
    ``convert_cpn_coco`` onto the port model's own tree."""
    target = bridge.cpn_coco_to_jax(
        train_coco.build_model(train_coco.tiny_backbone(), "cpu"))
    sd = torch_oracle.random_state_dict_for_coco(
        target, np.random.RandomState(0))
    return sd, convert.convert_cpn_coco(sd, target)


def _port(v):
    model = train_coco.build_model(train_coco.tiny_backbone(), "cpu")
    model.load_state_dict(bridge.cpn_coco_from_jax(v))
    return model


def _jax(v):
    return jax.tree.map(jnp.asarray, v)


def _rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.sqrt(np.mean(b ** 2)) + 1e-12)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float64).reshape(-1)
                           for x in jax.tree.leaves(tree)])


def test_the_bridge_round_trips_and_covers_every_tensor(variables):
    _, v = variables
    model = _port(v)
    back = bridge.cpn_coco_to_jax(model)
    assert jax.tree.structure(back) == jax.tree.structure(v)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, back, v)))
    sd = bridge.cpn_coco_from_jax(v)
    assert set(sd) == set(model.state_dict())
    with pytest.raises(RuntimeError, match="Missing"):
        model.load_state_dict({k: t for k, t in sd.items()
                               if "resnet_conv1" not in k})


def test_eval_heads_and_refine_maps_match_jax(variables):
    """Eval mode (running statistics): the four global heads, the refine
    head and the four refine maps (``with_fms``)."""
    _, v = variables
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    jm = JCPNCoco(cfg=jtrain_coco.tiny_backbone(), train=False)
    jg, jr, jf = jax.jit(lambda v, x: jm.apply(v, x, with_fms=True))(
        _jax(v), jnp.asarray(x))
    with torch.no_grad():
        g, r, f = _port(v).eval()(torch.from_numpy(x), with_fms=True)
    assert len(g) == 4 and r.shape == (2, 16, 16, 17)
    for ours, theirs in zip([*g, r, *f], [*jg, jr, *jf]):
        assert ours.shape == theirs.shape
        assert _rel_max(ours.numpy(), theirs) < HEAD_RTOL


def test_the_model_computes_channels_last(variables):
    """Weights and every convolution's input are channels-last (no
    per-layer NHWC<->NCHW copies); the heads come back contiguous in the
    JAX package's NHWC order."""
    _, v = variables
    x = torch.from_numpy(
        np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32))
    model = _port(v).eval()
    layouts = []
    for conv in (m for m in model.modules()
                 if isinstance(m, torch.nn.Conv2d)):
        assert conv.weight.is_contiguous(memory_format=torch.channels_last)
        conv.register_forward_pre_hook(lambda _, a: layouts.append(
            a[0].is_contiguous(memory_format=torch.channels_last)))
    with torch.no_grad():
        global_outs, refine = model(x)
    assert layouts and all(layouts)
    for out in (*global_outs, refine):
        assert out.is_contiguous() and out.shape[-1] == 17


def test_coco_losses_match_jax():
    rng = np.random.RandomState(0)
    n, oh, ow, k = 3, 8, 6, 17
    outs = [rng.randn(n, oh, ow, k).astype(np.float32) for _ in range(4)]
    tgts = [rng.rand(n, oh, ow, k).astype(np.float32) * 255 for _ in range(4)]
    valid = rng.randint(0, 3, (n, k)).astype(np.float32)
    g = losses.coco_global_loss([torch.from_numpy(o) for o in outs],
                                torch.from_numpy(np.stack(tgts)),
                                torch.from_numpy(valid))
    jg = jlosses.coco_global_loss([jnp.asarray(o) for o in outs],
                                  [jnp.asarray(t) for t in tgts],
                                  jnp.asarray(valid))
    r = losses.coco_refine_ohkm_loss(torch.from_numpy(outs[0]),
                                     torch.from_numpy(tgts[3]),
                                     torch.from_numpy(valid))
    jr = jlosses.coco_refine_ohkm_loss(jnp.asarray(outs[0]),
                                       jnp.asarray(tgts[3]),
                                       jnp.asarray(valid))
    # fp32 means over 2,448 values in another order
    assert float(g) == pytest.approx(float(jg), rel=1e-5)
    assert float(r) == pytest.approx(float(jr), rel=1e-5)


def test_lr_schedule_is_optaxs_across_the_boundaries():
    """``optax.piecewise_constant_schedule`` scales from the count equal to
    a boundary on (its indicator is ``sign(boundary - count)`` clipped at
    0): with 2 steps an epoch the rate halves at update 12, the first of
    epoch 6."""
    ours, theirs = train_coco.lr_schedule(2), jtrain_coco.lr_schedule(2)
    for count in range(0, 40):
        assert ours(count) == pytest.approx(float(theirs(count)), rel=1e-7)
    assert ours(11) == train_coco.LR and ours(12) == train_coco.LR / 2


def _named(model, params, stats):
    """A JAX ``params``-shaped tree (parameters, gradients or updates) as
    float64 tensors keyed by the port's parameter names."""
    sd = bridge.cpn_coco_from_jax({"params": jax.tree.map(np.asarray, params),
                                   "batch_stats": jax.tree.map(np.asarray,
                                                               stats)})
    return {k: sd[k].double() for k, _ in model.named_parameters()}


def _rel(a: dict, b: dict, keys=None) -> float:
    keys = list(b) if keys is None else keys
    x = torch.cat([a[k].reshape(-1) for k in keys])
    y = torch.cat([b[k].reshape(-1) for k in keys])
    return float(torch.linalg.norm(x - y) / torch.linalg.norm(y))


def test_three_adam_steps_across_the_lr_boundary_match_jax(variables):
    """Three train steps (live BN, Adam with L2 weight decay) from update
    count 11 with 2 steps an epoch, so that the rate halves at the second,
    against the JAX package's on its synthetic batches. Each step starts
    the port from JAX's parameters and BN statistics and takes JAX's
    ``train_step`` in its two halves: ``loss_fn``'s value and gradient (the
    loss to LOSS_RTOL, the BN running statistics to STATS_RTOL), then
    ``tx.update``: the port's Adam, fed JAX's gradient, moves the
    parameters as optax does (UPDATE_RTOL over the tree, UPDATE_LEAF_RTOL a
    tensor). The gradient itself is held on the initial weights, leaf by
    leaf but for those whose reference gradient vanishes (VANISHING), and
    against the port's own in fp64. Relative L2 norms throughout.

    Free-running, the two trajectories part far more than the gradients
    do: Adam's first steps move each element by about lr * sign(gradient),
    so an element whose gradient is rounding noise steps either way."""
    _, v = variables
    batches = list(jtrain_coco._synthetic_batches(
        np.random.RandomState(0), 3, 2))
    ours = list(train_coco._synthetic_batches(np.random.RandomState(0), 3, 2))
    for a, b in zip(batches, ours):
        assert all(jax.tree.leaves(jax.tree.map(np.array_equal, a, b)))

    jm = JCPNCoco(cfg=jtrain_coco.tiny_backbone(), train=True)
    tx = jtrain_coco.make_optimizer(2)
    grad_fn = jax.jit(jax.value_and_grad(jtrain_coco.loss_fn, has_aux=True),
                      static_argnums=2)

    @jax.jit
    def update(grads, opt_state, params):  # train_step's second half
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    params, stats = _jax(v["params"]), _jax(v["batch_stats"])
    empty, adam, sched = tx.init(params)
    opt_state = (empty, adam._replace(count=jnp.asarray(11, jnp.int32)),
                 sched._replace(count=jnp.asarray(11, jnp.int32)))
    model = _port(v)
    named = dict(model.named_parameters())
    opt = train_coco.Optimizer(model.parameters(), 2)
    opt.count = 11
    for p in model.parameters():
        opt.adam.state[p] = {"step": torch.tensor(11.0),
                             "exp_avg": torch.zeros_like(p),
                             "exp_avg_sq": torch.zeros_like(p)}
    readings = []
    for i, batch in enumerate(batches):
        model.load_state_dict(bridge.cpn_coco_from_jax(
            {"params": jax.tree.map(np.asarray, params),
             "batch_stats": jax.tree.map(np.asarray, stats)}))
        (loss, (_, _, new_stats)), grads = grad_fn(
            params, stats, jm, jax.tree.map(jnp.asarray, batch))
        before = params
        params, opt_state = update(grads, opt_state, params)

        host = pipeline.to_device(train_coco.host_batch(batch), "cpu")
        model.train()
        opt.zero_grad()
        mine, _, _ = train_coco.loss_fn(model, host)
        mine.backward()
        assert mine.item() == pytest.approx(float(loss), rel=LOSS_RTOL)
        assert _rel_l2(_flat(bridge.cpn_coco_to_jax(model)["batch_stats"]),
                       _flat(new_stats)) <= STATS_RTOL
        if i == 0:
            theirs = _named(model, grads, new_stats)
            tree_rms = float(torch.cat([g.reshape(-1) for g in
                                        theirs.values()]).pow(2).mean()
                             .sqrt())
            held = [k for k, g in theirs.items()
                    if float(g.pow(2).mean().sqrt()) >= VANISHING * tree_rms]
            assert sorted(set(theirs) - set(held)) == [
                f"global_net_upsamples_{j}_1.bn.bias" for j in range(3)]
            ours_g = {k: p.grad.double() for k, p in named.items()}
            fp64 = _port_fp64_grad(model, host)
            readings.append(f"gradient on the initial weights: port-JAX "
                            f"{_rel(ours_g, theirs, held):.2e}, JAX-port "
                            f"fp64 {_rel(theirs, fp64, held):.2e}, port-port "
                            f"fp64 {_rel(ours_g, fp64, held):.2e}")
            assert _rel(ours_g, theirs, held) <= GRAD_RTOL
            assert max(_rel(ours_g, theirs, [k]) for k in held) \
                <= GRAD_LEAF_RTOL
            assert _rel(ours_g, fp64, held) <= PORT_FP64_RTOL

        start = {k: p.detach().double().clone() for k, p in named.items()}
        for k, g in _named(model, grads, new_stats).items():
            named[k].grad = torch.empty_like(named[k]).copy_(g)
        opt.step()
        moved = {k: p.detach().double() - start[k] for k, p in named.items()}
        want = _named(model, jax.tree.map(
            lambda a, b: np.asarray(a) - np.asarray(b), params, before),
            new_stats)
        worst = max(_rel(moved, want, [k]) for k in want)
        readings.append(f"update {i}: tree {_rel(moved, want):.2e}, worst "
                        f"tensor {worst:.2e}")
        assert _rel(moved, want) <= UPDATE_RTOL
        assert worst <= UPDATE_LEAF_RTOL
        stats = new_stats
    print("; ".join(readings))
    assert opt.count == 14
    assert opt.adam.param_groups[0]["lr"] == train_coco.LR / 2


def _port_fp64_grad(model, batch) -> dict:
    """The port's gradient, computed in fp64, on ``model``'s weights and
    ``batch`` (train mode: the batch statistics normalize)."""
    m = copy.deepcopy(model).double().train()
    m.zero_grad(set_to_none=True)
    loss, _, _ = train_coco.loss_fn(
        m, type(batch)(*(t.double() for t in batch)))
    loss.backward()
    return {k: p.grad for k, p in m.named_parameters()}


def test_flip_eval_step_matches_jax(variables):
    _, v = variables
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    jm = JCPNCoco(cfg=jtrain_coco.tiny_backbone(), train=False)
    theirs = jtrain_coco.eval_step(jm, _jax(v), jnp.asarray(x), True)
    ours = train_coco.eval_step(_port(v), torch.from_numpy(x), True)
    assert _rel_max(ours.numpy(), theirs) < HEAD_RTOL
    plain = train_coco.eval_step(_port(v), torch.from_numpy(x), False)
    assert not torch.allclose(plain, ours)


def test_reference_checkpoint_loads_through_convert_and_the_bridge(
        variables, tmp_path):
    """``--torch-ckpt``: a reference torch state dict through the port's
    ``convert_cpn_coco`` (target ``cpn_coco_to_jax`` of a fresh model) and
    ``cpn_coco_from_jax``: the variables the JAX package's converter gives."""
    sd, _ = variables
    path = tmp_path / "cpn.pth.tar"
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(a)
                               for k, a in sd.items()}}, path)
    model = train_coco.build_model(train_coco.tiny_backbone(), "cpu")
    train_coco.load_torch_checkpoint(model, str(path))
    jm = JCPNCoco(cfg=jtrain_coco.tiny_backbone(), train=False)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    theirs = jconvert.convert_cpn_coco(sd, shapes)
    ours = bridge.cpn_coco_to_jax(model)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, ours, theirs)))


def test_latest_npz_moves_between_the_packages(variables, tmp_path):
    """``latest.npz`` under the JAX package's ``_save`` keys: the port's
    file read by JAX's ``_restore``, and JAX's file read by the port's."""
    _, v = variables
    jm = JCPNCoco(cfg=jtrain_coco.tiny_backbone(), train=False)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    train_coco._save(str(tmp_path / "port"), 3, _port(v))
    params, stats, epoch = jtrain_coco._restore(
        str(tmp_path / "port"), shapes["params"], shapes["batch_stats"])
    assert epoch == 3
    got = {"params": params, "batch_stats": stats}
    assert all(jax.tree.leaves(jax.tree.map(
        lambda a, b: np.array_equal(np.asarray(a), b), got, v)))
    jtrain_coco._save(str(tmp_path / "jax"), 5, _jax(v["params"]),
                      _jax(v["batch_stats"]))
    model = train_coco.build_model(train_coco.tiny_backbone(), "cpu")
    assert train_coco._restore(str(tmp_path / "jax"), model) == 5
    assert all(jax.tree.leaves(jax.tree.map(
        np.array_equal, bridge.cpn_coco_to_jax(model), v)))


def _write_tiny_coco(tmp_path, n_imgs=3):
    """``tests/test_cpn_coco.py``'s tiny person_keypoints set."""
    import cv2

    img_dir = tmp_path / "imgs"
    os.makedirs(img_dir, exist_ok=True)
    images, anns = [], []
    rng = np.random.RandomState(0)
    for i in range(n_imgs):
        w, h = 96, 80
        cv2.imwrite(str(img_dir / f"{i:012d}.jpg"),
                    rng.randint(0, 255, (h, w, 3), np.uint8))
        images.append({"id": i, "file_name": f"{i:012d}.jpg",
                       "width": w, "height": h})
        kps = np.zeros((17, 3))
        kps[:, 0] = rng.uniform(25, 70, 17)
        kps[:, 1] = rng.uniform(20, 60, 17)
        kps[:, 2] = rng.randint(1, 3, 17)
        anns.append({
            "id": 100 + i, "image_id": i, "category_id": 1,
            "keypoints": kps.reshape(-1).tolist(),
            "num_keypoints": 17, "iscrowd": 0,
            "bbox": [20.0, 15.0, 55.0, 50.0], "area": 55.0 * 50.0,
        })
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps({"images": images, "annotations": anns}))
    return str(ann), str(img_dir)


def test_train_coco_cli_trains_checkpoints_and_evaluates(tmp_path):
    """``--synthetic --tiny --device cpu`` trains (the loss finite, the BN
    statistics moved) and writes ``latest.npz``; ``--eval`` on a tiny
    person_keypoints set reads it back and reports OKS AP, writing
    ``result.json``; ``--device`` defaults to ``cuda``."""
    ckpt = str(tmp_path / "ckpt")
    out = train_coco.main(["--synthetic", "--tiny", "--device", "cpu",
                           "--epochs", "1", "--steps-per-epoch", "2",
                           "--batch", "2", "--checkpoint", ckpt])
    assert len(out["history"]) == 1 and np.isfinite(out["history"][0])
    bn = out["model"].m("resnet.conv1").bn
    assert not torch.equal(bn.running_var, torch.ones_like(bn.running_var))
    ann, img_dir = _write_tiny_coco(tmp_path)
    summary = train_coco.main([
        "--eval", "--device", "cpu", "--ann", ann, "--image-dir", img_dir,
        "--tiny", "--batch", "2", "--checkpoint", ckpt,
        "--result", str(tmp_path / "out")])
    assert set(summary) == {"AP", "AP50", "AP75", "AP_medium", "AP_large",
                            "AR"}
    assert 0.0 <= summary["AP"] <= 1.0
    # no ground truth is large here: that area range has no AP (nan)
    assert all(0.0 <= v <= 1.0 for k, v in summary.items()
               if k != "AP_large")
    results = json.loads((tmp_path / "out" / "result.json").read_text())
    assert len(results) == 3
    assert all(len(r["keypoints"]) == 51 for r in results)
    assert train_coco.build_argparser().parse_args([]).device == "cuda"
