"""The plain reference on the CPU: it names the program's parameters,
agrees with the program at a tiny size, its int4 control does not, and its
FLOP count of each parity graph equals the program's own count
(``FLOPS_torch.json``)."""

import json
import math

import pytest
import torch

from portbench import entry, flops, weights
from portbench.drivers import serving
from portbench.reference.model import Model, param_specs
from portbench.tests import tiny
from portbench.tests.tiny import BENCH, ROOT, SERVING, TRAINING

CONFIGS = {c["name"]: json.loads((ROOT / c["file"]).read_text())
           for c in BENCH["configs"]}
FLOPS = json.loads((ROOT / "FLOPS_torch.json").read_text())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_names_every_parameter_of_the_program(name):
    from contextaware_poseformer_tpu_torch.models.capf import (
        ContextAwarePoseFormer,
    )

    cfg = CONFIGS[name]
    model = ContextAwarePoseFormer(entry.program_config(cfg).model,
                                   device="meta")
    program = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert {n: tuple(s) for n, s, _ in param_specs(cfg)} == program


@pytest.mark.parametrize("name,preset,train", [
    ("h36m_cpn_train", "h36m_cpn", False),
    ("h36m_cpn_train", "h36m_cpn", True),
    ("h36m_hrnet_32_deploy", "h36m_hrnet_32", False),
    ("h36m_hrnet_32_deploy", "h36m_hrnet_32", True),
])
def test_flop_count_equals_the_programs(name, preset, train):
    key = "train_gflops_per_frame" if train else "gflops_per_frame"
    got = flops.gflops_per_item(CONFIGS[name], train=train)
    assert round(got, 3) == FLOPS[preset][key]


def test_deploy_graph_count_skips_the_pyramid_resizes():
    got = flops.gflops_per_item(CONFIGS["h36m_cpn_deploy"])
    assert 10.40 < got < FLOPS["h36m_cpn"]["gflops_per_frame"]


def test_int8_least_time_of_the_cpn_request():
    # bytes-bound: the K10 bound of a batch-64 request is 0.760 ms
    least = flops.int8_conv_least_s(CONFIGS["h36m_cpn_deploy"], 64)
    assert least * 1e3 == pytest.approx(0.760, rel=0.01)
    # activations scale with the batch, weights do not
    ratio = flops.int8_conv_least_s(CONFIGS["h36m_cpn_deploy"], 256) / least
    assert 3.9 < ratio < 4.0


def test_weights_are_seeded_and_fan_in_scaled():
    cfg = tiny.shrink(json.loads(json.dumps(CONFIGS["h36m_cpn_deploy"])))
    a = weights.make(cfg, 2 ** 31 + 5, "cpu")
    b = weights.make(cfg, 2 ** 31 + 5, "cpu")
    c = weights.make(cfg, 2 ** 31 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["lifter.head.kernel"], c["lifter.head.kernel"])
    w = a["backbone.resnet_layer1_0_conv2.weight"]
    assert w.std().item() == pytest.approx(1 / math.sqrt(64 * 9), rel=0.1)


@pytest.mark.parametrize("name", SERVING)
def test_serving_reference_agrees_with_the_program(name):
    from contextaware_poseformer_tpu_torch import serve

    cell = tiny.cell(name)
    cfg = cell.config
    params = weights.make(cfg, 2 ** 31 + 21, "cpu")
    model = entry.serving_model(entry.program_config(cfg), params, "cpu")
    pool = serving.ServingPool(cfg, cell.traffic, 2 ** 31 + 21, "cpu")
    serve.prepare(model, [pool.calibration])
    ref = serving.reference_poses(cfg, params, pool, "cpu")
    control = serving.reference_poses(cfg, params, pool, "cpu", levels=7)
    program = [serve.lift(model, pool.frames[k], pool.kp2d[k], pool.crop[k])
               for k in range(len(pool))]
    unit = serving.int8_units(cell, params, pool, "cpu", ref)
    gap = serving.widest(enumerate(program), ref, unit)
    ctl = serving.widest(enumerate(control), ref, unit)
    # the program rounds its backbone to bf16, about as far as int8's own
    # effect; the int4 control is some ten times that
    assert gap < 2.0
    assert ctl > 3 * gap


def test_reference_calibration_follows_the_programs():
    from contextaware_poseformer_tpu_torch import serve

    cell = tiny.cell(SERVING[0])
    cfg = cell.config
    params = weights.make(cfg, 2 ** 31 + 22, "cpu")
    model = entry.serving_model(entry.program_config(cfg), params, "cpu")
    pool = serving.ServingPool(cfg, cell.traffic, 2 ** 31 + 22, "cpu")
    serve.prepare(model, [pool.calibration])
    ref = Model(cfg, params)
    ref.calibrate(pool.calibration, cfg["calibration"]["chunk"])
    buffers = dict(model.backbone.named_buffers())
    checked = 0
    for name, value in ref.backbone.scales.items():
        buf = buffers.get(name.replace(".", "_") + "_amax",
                          buffers.get(name.replace(".", "_") + ".amax"))
        assert buf is not None, name
        # the program observes bf16 tensors, the reference fp32 ones
        assert float(value) == pytest.approx(float(buf), rel=0.05), name
        checked += 1
    assert checked > 10


@pytest.mark.parametrize("name", TRAINING)
def test_training_reference_follows_the_programs_steps(name):
    run = tiny.run(tiny.cell(name), seconds=0.0)
    rows = [int(i) for r in run.inputs["rows"] for i in r]
    assert len(run.inputs["rows"]) == 3 and len(set(rows)) == len(rows)
    got = {k: v for k, (v, _) in run.compared.items()}
    assert got["loss_gap"] < 1e-5
    assert got["grad_gap"] < 1e-4
    assert got["change_gap"] < 1e-2
