"""The check on a depthwise-separable net (the tiny Xception, `txc.txcp`):
which layers a job solves, shrinks and gates; the plain builder against the
port's graph; and the tiny VGG and ResNet cells still read, bit for bit,
what they read before depthwise chains were judged."""
import pytest

from port_bench import checks, harness, job, shapes
from port_bench.configs import xception

XCEPTION = {"stem_widths": [32, 64], "entry_widths": [128, 256, 728],
            "middle_blocks": 8, "exit_widths": [728, 1024, 1536, 2048],
            "num_classes": 1000, "bn_eps": 1e-9}


def test_solved_layers_of_a_depthwise_separable_net(tiny_root):
    cell = harness.load_cell(tiny_root, "txc.txcp")
    orig = cell.layers()
    by = {l["name"]: l for l in orig}
    items = {it["consumer"]: it for it in checks.solved_layers(orig, cell.traffic)}
    pws = [n for n in by if n.endswith("_pw")]
    assert set(items) == {"conv2", "entry1_shortcut", *pws}
    assert len(items) == 18
    assert all(int(by[c]["attrs"].get("group", 1)) == 1 for c in items)
    # conv2 also feeds entry1_sep1_dw: the shortcut is gated, conv2 keeps
    # its width
    assert items["entry1_shortcut"] == {"consumer": "entry1_shortcut",
                                        "producer": None, "target": 4,
                                        "gate": True, "depthwise": []}
    assert items["entry1_sep1_pw"]["gate"]
    assert items["entry1_sep1_pw"]["depthwise"] == ["entry1_sep1_dw"]
    assert items["conv2"]["producer"] == "conv1" and not items["conv2"]["gate"]
    # a pointwise conv shrinks the one above it through the depthwise conv
    assert items["entry1_sep2_pw"] == {"consumer": "entry1_sep2_pw",
                                       "producer": "entry1_sep1_pw", "target": 9,
                                       "gate": False,
                                       "depthwise": ["entry1_sep2_dw"]}
    assert items["exit_sep4_pw"]["producer"] == "exit_sep3_pw"
    # the first of each block's separable convs reads a junction: a gate
    for c in ("entry2_sep1_pw", "mid1_sep1_pw", "mid2_sep1_pw", "exit_sep1_pw",
              "exit_sep3_pw"):
        assert items[c]["gate"] and items[c]["depthwise"] == [c[:-3] + "_dw"]


def test_the_builder_is_the_ports_graph():
    from channel_pruning_tpu_torch.graph import rewrite
    from channel_pruning_tpu_torch.models import zoo

    layers = xception.layers(XCEPTION)
    port = rewrite.split_relu(zoo.get_model("xception", batch=1, image_size=299))
    assert [(l["name"], l["type"], l["bottoms"], l["tops"]) for l in layers] == \
        [(l.name, l.type, list(l.bottoms), list(l.tops)) for l in port.layers]
    s = shapes.tensor_shapes(layers, (1, 3, 299, 299))
    # pad 1 on conv1 and conv2: 150², not the paper's 149² and 147²
    assert [s[t][2] for t in ("conv1", "conv2", "entry1", "entry2", "entry3",
                              "mid8", "exit")] == [150, 150, 75, 38, 19, 19, 10]
    assert s["exit_sep4_pw"] == (1, 2048, 10, 10)
    assert sum(shapes.conv_mults(layers, (1, 3, 299, 299)).values()) == 8_468_704_656


# the check"s readings before depthwise chains were judged (the parent
# commit"s port_bench/checks.py), on the job of run seed 3
PARENT = {
    ("tvgg.tcp", False): {"freeze_gap": 0.0,
     "counts_off": 0.0,
     "select_off": 0.0,
     "refit_excess": 0.0003073916589689156,
     "model_rel_err": 0.8488028218325346,
     "refit_excess_each": {"conv1_2": 3.843994549109537e-06,
                           "conv2_1": 1.2741128225064939e-05,
                           "conv2_2": 5.454469560334526e-05,
                           "conv3_1": 0.00018020049098967718,
                           "conv3_2": 0.0003073916589689156},
     "select_off_each": {"conv1_2": 0.0,
                         "conv2_1": 0.0,
                         "conv2_2": 0.0,
                         "conv3_1": 0.0,
                         "conv3_2": 0.0}},
    ("tvgg.tcp", True): {"freeze_gap": 0.0032470598585919606,
     "counts_off": 0.0,
     "select_off": 0.0,
     "refit_excess": 0.0059231962025401465,
     "model_rel_err": 0.8488028218325346,
     "refit_excess_each": {"conv1_2": 0.0003887100168827988,
                           "conv2_1": 0.0014745771447826855,
                           "conv2_2": 0.0023782249705646538,
                           "conv3_1": 0.0059231962025401465,
                           "conv3_2": 0.002622051552066219},
     "select_off_each": {"conv1_2": 0.0,
                         "conv2_1": 0.0,
                         "conv2_2": 0.0,
                         "conv3_1": 0.0,
                         "conv3_2": 0.0}},
    ("tres.trcp", False): {"freeze_gap": 0.0,
     "counts_off": 0.0,
     "select_off": 0.0,
     "refit_excess": 8.482979815581873e-12,
     "model_rel_err": 0.01030676212630342,
     "refit_excess_each": {"res2a_branch2b": 8.482979815581873e-12,
                           "res2b_branch2a": 6.660330464167413e-13,
                           "res2b_branch2c": 1.4437293552703656e-13,
                           "res3a_branch2c": 2.102439073872829e-12},
     "select_off_each": {"res2a_branch2b": 0.0,
                         "res2b_branch2a": 0.0,
                         "res2b_branch2c": 0.0,
                         "res3a_branch2c": 0.0}},
    ("tres.trcp", True): {"freeze_gap": 0.006219175944481461,
     "counts_off": 0.0,
     "select_off": 0.0,
     "refit_excess": 8.217295966612073e-08,
     "model_rel_err": 0.01030676212630342,
     "refit_excess_each": {"res2a_branch2b": 8.217295966612073e-08,
                           "res2b_branch2a": 1.2835901570921617e-08,
                           "res2b_branch2c": 3.224625520041572e-09,
                           "res3a_branch2c": 1.2671895425904983e-08},
     "select_off_each": {"res2a_branch2b": 0.0,
                         "res2b_branch2a": 0.0,
                         "res2b_branch2c": 0.0,
                         "res3a_branch2c": 0.0}},
}


@pytest.mark.parametrize("name, control", list(PARENT))
def test_the_vgg_and_resnet_cells_read_what_they_read_before(tiny_root, name,
                                                             control):
    """The check before depthwise chains were judged read these numbers on
    the same job (run seed 3, the problem of the cell), bit for bit."""
    cell = harness.load_cell(tiny_root, name)
    prog = job.Program(cell.config, cell.traffic, "cpu")
    orig, params, sets, held = harness.make_inputs(cell, prog, 3, "cpu", 1)
    res = prog.run(params, sets[0], job.Spans(), job=0)
    j = checks.judge(orig, params, sets[0], held, cell.config, cell.traffic,
                     harness.job_settings(prog), job.plain_layers(res.graph),
                     res.params, res.selections, res.cache.feats, res.cache.plan,
                     harness.report_alphas(res.reports), "cpu", control=control)
    got = {**j["numbers"], "model_rel_err": j["detail"]["model_rel_err"],
           "refit_excess_each": j["detail"]["refit_excess_each"],
           "select_off_each": j["detail"]["select_off_each"]}
    assert got.pop("depthwise_off") == 0.0          # no depthwise conv
    assert got == PARENT[(name, control)]
