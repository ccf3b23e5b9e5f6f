"""The port's accuracy-loop subcommands (`finetune`, `eval`, `time`,
`deploy`, `addbn`, `splitrelu`, `verify-release`, `prune --data-dir`, and
the `flop --model` repair) through `cli.main` on the CPU, against the JAX
CLI where both compute the same thing from the same files: `addbn` on the
same LMDB calibration set (parameters to rtol 1e-5), `splitrelu` (equal
files), `flop` (the same ratio line)."""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from channel_pruning_tpu import cli as jax_cli
from channel_pruning_tpu_torch import cli, deploy
from channel_pruning_tpu_torch.convert import params_to_torch
from channel_pruning_tpu_torch.data.lmdb import Datum, encode_datum, write_lmdb
from channel_pruning_tpu_torch.io import caffe as cio
from channel_pruning_tpu_torch.ops.forward import run_graph
from torch_cpu import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _template_lmdb(path: Path, n: int = 64, size: int = 16, classes: int = 10,
                   seed: int = 0) -> Path:
    """Raw uint8 BGR Datums: one smooth template per class plus noise."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(40, 215, (classes, 3, 4, 4))
    templates = np.kron(base, np.ones((1, 1, size // 4, size // 4)))
    items = []
    for i in range(n):
        c = i % classes
        img = np.clip(templates[c] + rng.normal(0, 20, templates[c].shape), 0, 255)
        d = Datum(channels=3, height=size, width=size,
                  data=img.astype(np.uint8).tobytes(), label=c)
        items.append((f"{i:06d}".encode(), encode_datum(d)))
    write_lmdb(path, items)
    return path


def _prune_tiny(wd: Path, *extra: str):
    return cli.main(["prune", "--model", "tiny_vgg", "--batch", "4",
                     "--cal-batches", "4", "--cal-batch", "4", "--speed", "2.0",
                     "--device", "cpu", "--work-dir", str(wd), *extra])


def test_prune_from_lmdb_carries_labels_and_addbn_matches_jax(tmp_path):
    db = _template_lmdb(tmp_path / "db")
    wd = tmp_path / "w"
    _prune_tiny(wd, "--data-dir", str(db), "--input-scale", "0.0078125")
    from channel_pruning_tpu_torch.sampling.sampler import FrozenCache

    cache = FrozenCache.load(wd / "frozen_4x4.npz")
    assert cache.labels.shape == (4, 4) and cache.inputs.shape == (4, 4, 3, 16, 16)
    assert np.abs(cache.inputs).max() < 2.0              # scaled by 1/128
    args = ["addbn", "--prototxt", str(wd / "cp_tiny_vgg.prototxt"),
            "--weights", str(wd / "cp_tiny_vgg.caffemodel"), "--batch", "4",
            "--cal-batches", "3", "--cal-batch", "4", "--data-dir", str(db)]
    g2, p2 = cli.main(args + ["--device", "cpu", "--work-dir", str(wd / "port")])
    jax_cli.main(args + ["--work-dir", str(wd / "jax")])
    g_j, p_j = cio.import_model(wd / "jax/bn_tiny_vgg.prototxt",
                                wd / "jax/bn_tiny_vgg.caffemodel")
    g_p, p_p = cio.import_model(wd / "port/bn_tiny_vgg.prototxt",
                                wd / "port/bn_tiny_vgg.caffemodel")
    assert (wd / "port/bn_tiny_vgg.prototxt").read_text() == \
        (wd / "jax/bn_tiny_vgg.prototxt").read_text()
    assert sum(l.type == "BatchNorm" for l in g2.layers) == 6
    for layer in p_j:
        for k in p_j[layer]:
            np.testing.assert_allclose(p_p[layer][k], p_j[layer][k], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{layer}.{k}")


def test_splitrelu_equals_jax(tmp_path):
    for mod, sub in ((cli, "port"), (jax_cli, "jax")):
        mod.main(["splitrelu", "--model", "tiny_vgg", "--batch", "2",
                  "--work-dir", str(tmp_path / sub)])
    assert (tmp_path / "port/s_tiny_vgg.prototxt").read_text() == \
        (tmp_path / "jax/s_tiny_vgg.prototxt").read_text()


def test_flop_model_names_the_ratio(tmp_path, capsys):
    """A VGG prototxt whose name is not a registry key: with --model vgg16
    both CLIs divide by VGG-16's published count; without --model the port
    looks the graph's name up (no ratio here), --orig-flops overrides."""
    from channel_pruning_tpu_torch.models.vgg import build_vgg16, init_params

    g = build_vgg16(batch=1, cfg=((1, 2, 16), (2, 2, 32), (3, 3, 64),
                                  (4, 3, 64), (5, 3, 64)),
                    fc_dims=(64,), name="released_vgg")
    cio.export_model(g, init_params(g), tmp_path / "r.prototxt",
                     tmp_path / "r.caffemodel")
    args = ["flop", "--prototxt", str(tmp_path / "r.prototxt"), "--batch", "1"]

    def ratio(main, extra):
        capsys.readouterr()
        main(args + extra)
        return [l for l in capsys.readouterr().out.splitlines() if "% of original" in l]

    got = ratio(cli.main, ["--model", "vgg16"])
    assert got and got == ratio(jax_cli.main, ["--model", "vgg16"])
    assert ratio(cli.main, []) == []
    assert ratio(cli.main, ["--model", "vgg16", "--orig-flops", "1000"]) == \
        ratio(jax_cli.main, ["--model", "vgg16", "--orig-flops", "1000"])


def test_deploy_reloads_and_equals_run_graph(tmp_path):
    out = cli.main(["deploy", "--model", "tiny_vgg", "--batch", "2",
                    "--device", "cpu", "--work-dir", str(tmp_path)])
    assert out.endswith("tiny_vgg.pt2")
    fn = deploy.load_serialized(out)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 3, 16, 16)).astype(np.float32))
    from channel_pruning_tpu_torch.models.vgg import build_tiny_vgg

    g, p = build_tiny_vgg(batch=2, image_size=16)
    want = run_graph(g, params_to_torch(p, "cpu"), {"data": x})[0]["prob"]
    torch.testing.assert_close(fn(x), want, rtol=0, atol=1e-6)
    serve = deploy.serving_fn(g, None, "fc8", device="cpu")
    assert serve(params_to_torch(p, "cpu"), x).shape == (2, 10)


@pytest.mark.parametrize("extra", [
    ["--iters", "3"],
    ["--loop-steps", "3", "--dtype", "bfloat16"],
    ["--per-layer", "--per-layer-steps", "2"],
])
def test_time_runs(tmp_path, extra, capsys):
    res = cli.main(["time", "--model", "tiny_vgg", "--batch", "4",
                    "--device", "cpu", *extra])
    assert res["images_per_sec" if "--per-layer" not in extra else "sum_ms"] > 0
    assert res["device"] == "cpu" and res["flags"]["tf32_cudnn"] is False
    if "--per-layer" not in extra:
        assert res["mfu"] is None               # no peak is claimed for a CPU


def test_time_per_layer_compares_a_pruned_model(tmp_path, capsys):
    _prune_tiny(tmp_path)
    res = cli.main(["time", "--model", "tiny_vgg", "--batch", "4",
                    "--per-layer", "--per-layer-steps", "2",
                    "--compare-prototxt", str(tmp_path / "cp_tiny_vgg.prototxt"),
                    "--compare-weights", str(tmp_path / "cp_tiny_vgg.caffemodel"),
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "pruned ms" in out and "TOTAL" in out and "CONV" in out
    names = [r["layer"] for r in res["layers"]]
    assert "conv1_1" in names and res["compare"]["sum_ms"] > 0
    conv = [r for r in res["compare"]["layers"] if r["layer"] == "conv1_1"][0]
    assert conv["mults"] < [r for r in res["layers"]
                            if r["layer"] == "conv1_1"][0]["mults"]


def test_verify_release_pass_and_fail(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    val = tmp_path / "val"
    for ci in range(2):
        (val / f"c{ci}").mkdir(parents=True)
        for i in range(4):
            Image.fromarray(rng.integers(0, 256, (40, 40, 3)).astype(np.uint8)) \
                .save(val / f"c{ci}" / f"{i}.png")
    wd = str(tmp_path)
    cli.main(["finetune", "--model", "tiny_vgg", "--batch", "4", "--steps", "1",
              "--device", "cpu", "--work-dir", wd])
    args = ["verify-release", "--prototxt", f"{wd}/ft_tiny_vgg.prototxt",
            "--weights", f"{wd}/ft_tiny_vgg.caffemodel", "--batch", "4",
            "--data-dir", str(val), "--iterations", "2", "--device", "cpu"]
    res = cli.main(args + ["--expect-top1", "0.0", "--expect-top5", "0.0"])
    assert res["verdict"] == "PASS" and res["measured"]["n_images"] == 8
    res = cli.main(args + ["--expect-top1", "0.99"])
    assert res["verdict"] == "FAIL" and "accuracy@1" in res["delta"]
    with pytest.raises(SystemExit, match="unknown release"):
        cli.main(args + ["--expect", "nope"])
    assert cli.RELEASED_ACCURACY == jax_cli.RELEASED_ACCURACY


def test_verify_release_takes_a_mean_image_over_lmdb(tmp_path):
    """`--mean` with an image-shaped mean over an LMDB: a mean image that
    holds the BGR pixel mean everywhere gives the default protocol's counts.
    The JAX CLI hands the (H, W, C) mean to its LMDB reader, which
    subtracts it from (C, H, W) crops and fails to broadcast."""
    from channel_pruning_tpu_torch.data.pipeline import BGR_MEAN

    db = _template_lmdb(tmp_path / "db", n=16)
    np.save(tmp_path / "m.npy", np.broadcast_to(
        BGR_MEAN[:, None, None], (3, 16, 16)).astype(np.float32))
    args = ["verify-release", "--model", "tiny_vgg", "--batch", "4",
            "--data-dir", str(db), "--iterations", "4"]
    plain = cli.main(args + ["--device", "cpu"])["measured"]
    with_mean = cli.main(args + ["--device", "cpu", "--mean",
                                 str(tmp_path / "m.npy")])["measured"]
    assert with_mean == plain and plain["n_images"] == 16
    with pytest.raises(ValueError, match="broadcast"):
        jax_cli.main(args + ["--mean", str(tmp_path / "m.npy")])


def test_finetune_and_eval_distill_against_a_teacher(tmp_path):
    """`--teacher-prototxt`: finetune a pruned tiny Faster-RCNN backbone
    against the original's RPN heads, then eval its head fidelity."""
    from channel_pruning_tpu_torch.models.faster_rcnn import build_tiny_frcnn

    g, p = build_tiny_frcnn(batch=2, image_size=32)
    cio.export_model(g, p, tmp_path / "t.prototxt", tmp_path / "t.caffemodel")
    teacher = ["--teacher-prototxt", str(tmp_path / "t.prototxt"),
               "--teacher-weights", str(tmp_path / "t.caffemodel")]
    state = cli.main(["finetune", "--prototxt", str(tmp_path / "t.prototxt"),
                      "--weights", str(tmp_path / "t.caffemodel"), "--batch", "2",
                      "--steps", "2", "--lr", "1e-3", "--device", "cpu",
                      "--work-dir", str(tmp_path), *teacher])
    assert state.step == 2 and float(state.history[0]["top1"]) == 1.0
    res = cli.main(["eval", "--prototxt", str(tmp_path / "ft_tiny_frcnn.prototxt"),
                    "--weights", str(tmp_path / "ft_tiny_frcnn.caffemodel"),
                    "--batch", "2", "--eval-batches", "2", "--device", "cpu",
                    *teacher])
    assert res["n_batches"] == 2 and "rpn_bbox_pred:neg_mae" in res


def test_synthetic_labels_fit_the_net(tmp_path):
    """Without --data-dir the JAX CLI draws labels below 1000 whatever the
    net: on a 10-class net optax's loss is NaN (its label gather fills out
    of range) and top-1 is 0. The port draws labels below the net's class
    count, so the loss is finite."""
    import jax.numpy as jnp
    import optax

    from channel_pruning_tpu.train import finetune as jax_ft

    _, y = next(jax_ft.synthetic_batches(4, image=16))
    assert y.max() >= 10
    assert np.isnan(np.asarray(optax.softmax_cross_entropy_with_integer_labels(
        jnp.zeros((4, 10)), jnp.asarray(y)))).any()
    state = cli.main(["finetune", "--model", "tiny_vgg", "--batch", "4",
                      "--steps", "2", "--device", "cpu", "--work-dir", str(tmp_path)])
    assert all(np.isfinite(float(m["loss"])) for m in state.history)
    g, _ = cio.import_model(tmp_path / "ft_tiny_vgg.prototxt")
    _, y_port = next(cli._synthetic(argparse.Namespace(batch=64), g))
    assert 0 <= y_port.min() and y_port.max() < 10


def test_device_defaults_to_cuda_everywhere(tmp_path, monkeypatch):
    """Every subcommand that touches a device resolves `cuda` unless told
    otherwise, before it does any work (so also on a host with a card)."""
    from channel_pruning_tpu_torch import device as port_device

    class Resolved(Exception):
        pass

    def refuse(name):
        raise Resolved(name)

    monkeypatch.setattr(port_device, "resolve_device", refuse)
    for cmd in ("prune", "combine", "addbn", "finetune", "eval", "time",
                "deploy", "verify-release"):
        argv = [cmd, "--model", "tiny_vgg", "--batch", "2"]
        argv += (["--data-dir", "nowhere"] if cmd == "verify-release"
                 else ["--work-dir", str(tmp_path)])
        with pytest.raises(Resolved) as e:
            cli.main(argv)
        assert str(e.value) == "cuda", cmd
    assert not list(tmp_path.iterdir())
    if not torch.cuda.is_available():
        monkeypatch.undo()
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["eval", "--model", "tiny_vgg", "--batch", "2",
                      "--work-dir", str(tmp_path)])


def test_accuracy_chain_runs_without_jax(tmp_path):
    """prune -> addbn -> finetune -> eval on the tiny VGG through the
    port's cli.main, over an LMDB, in a subprocess where `import jax` and
    `import channel_pruning_tpu` fail."""
    db = _template_lmdb(tmp_path / "db")
    wd = str(tmp_path)
    common = ["--batch", "4", "--device", "cpu", "--work-dir", wd,
              "--data-dir", str(db), "--input-scale", "0.0078125"]
    steps = [
        ["prune", "--model", "tiny_vgg", "--cal-batches", "4", "--cal-batch", "4",
         "--speed", "2.0"],
        ["addbn", "--prototxt", f"{wd}/cp_tiny_vgg.prototxt", "--weights",
         f"{wd}/cp_tiny_vgg.caffemodel", "--cal-batches", "2", "--cal-batch", "4"],
        ["finetune", "--prototxt", f"{wd}/bn_tiny_vgg.prototxt", "--weights",
         f"{wd}/bn_tiny_vgg.caffemodel", "--steps", "3", "--lr", "1e-3",
         "--clip-gradients", "35"],
        ["eval", "--prototxt", f"{wd}/ft_tiny_vgg.prototxt", "--weights",
         f"{wd}/ft_tiny_vgg.caffemodel", "--eval-batches", "4"],
    ]
    prog = (
        "import json, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['channel_pruning_tpu'] = None\n"
        "from channel_pruning_tpu_torch import cli\n"
        f"for argv in {[s + common for s in steps]!r}:\n"
        "    res = cli.main(argv)\n"
        "print('RESULT', json.dumps(res))\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'jax'\n"
        "            and sys.modules[m] is not None]\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", prog], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    res = json.loads(out.stdout.split("RESULT ", 1)[1])
    assert res["n_images"] == 16
    assert "[addbn] inserted BN after" in out.stdout
    assert "3/3 finite" in out.stdout
