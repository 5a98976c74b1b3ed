"""The port's roofline model (`repro_torch.launch.roofline`) against the
JAX package's, with JAX's module constants set to the H100's data-sheet
values for the test (the JAX files are not changed): on synthetic
dry-run records of every (arch x shape) cell, `_arch_bytes`,
`model_flops`, `analyse`, `to_markdown` and `to_csv` give the same
numbers and text."""
import json

import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs.shapes import SHAPE_ORDER, applicable  # noqa
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import roofline as roof  # noqa: E402


@pytest.fixture
def h100(monkeypatch):
    monkeypatch.setattr(jroof, "PEAK_FLOPS_BF16", M.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jroof, "HBM_BW", M.HBM_BW)
    monkeypatch.setattr(jroof, "ICI_BW", M.LINK_BW)


def _record(arch, shape, i, **kw):
    """A synthetic dry-run record of the port's keys (no "probe")."""
    cfg = get_config(arch)
    from repro_torch.configs.shapes import SHAPES
    spec = SHAPES[shape]
    rec = {"cell": f"{arch}_{shape}_pod256", "arch": arch, "shape": shape,
           "mesh": [16, 16], "chips": 256, "variant": "",
           "expert_gather": False, "kv_bits": 16, "mode": spec.mode,
           "params": cfg.param_count(),
           "active_params": cfg.active_param_count(),
           "tokens": spec.global_batch * (spec.seq_len if spec.mode !=
                                          "decode" else 1),
           "flops": 1.5e12 * (i + 1), "bytes_accessed": 7e11 * (i + 2),
           "collective_bytes": 3e9 * (i % 5), "collective_ops": 10 * i}
    rec.update(kw)
    return rec


CELLS = [(a, s) for a in list_archs() for s in SHAPE_ORDER]


def test_constants_are_the_h100s():
    assert (roof.PEAK_FLOPS_BF16, roof.HBM_BW, roof.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    assert roof.MSZ == roof.DSZ == 16


@pytest.mark.parametrize("arch,shape", CELLS)
def test_arch_bytes_and_model_flops_equal_jax(h100, arch, shape):
    for chips in (256, 512):
        for minimal in (False, True):
            assert roof._arch_bytes(get_config(arch), shape, chips,
                                    minimal) == \
                jroof._arch_bytes(jget_config(arch), shape, chips, minimal)
    rec = _record(arch, shape, 3)
    assert roof.model_flops(rec) == jroof.model_flops(rec)


@pytest.mark.parametrize("eg,kv", [(True, 16), (False, 8)])
def test_arch_bytes_hades_flags_equal_jax(h100, eg, kv):
    import dataclasses
    for arch in ("mixtral-8x7b", "olmoe-1b-7b", "glm4-9b"):
        rec = _record(arch, "decode_32k", 1, expert_gather=eg, kv_bits=kv)
        assert roof.analyse(rec) == jroof.analyse(rec)
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg, hades=dataclasses.replace(
            cfg.hades, expert_gather_decode=eg, kv_quant_bits=kv))
        jcfg = jget_config(arch)
        jcfg = dataclasses.replace(jcfg, hades=dataclasses.replace(
            jcfg.hades, expert_gather_decode=eg, kv_quant_bits=kv))
        assert roof._arch_bytes(cfg, "decode_32k", 256, False) == \
            jroof._arch_bytes(jcfg, "decode_32k", 256, False)


def test_analyse_and_tables_equal_jax(h100, tmp_path):
    recs = [_record(a, s, i) for i, (a, s) in enumerate(CELLS)
            if applicable(get_config(a), s)[0]]
    recs.append({"cell": "glm4-9b_long_500k_pod256", "skipped": "N/A"})
    rows = [roof.analyse(r) for r in recs]
    assert rows == [jroof.analyse(r) for r in recs]
    assert rows[-1] is None and all(rows[:-1])
    rows = rows[:-1]
    assert roof.to_markdown(rows) == jroof.to_markdown(rows)
    assert roof.to_csv(rows) == jroof.to_csv(rows)
    for r in recs:
        with open(tmp_path / f"{r['cell']}.json", "w") as f:
            json.dump(r, f)
    assert roof.load_all(str(tmp_path)) == jroof.load_all(str(tmp_path))
    assert len(roof.load_all(str(tmp_path))) == 33


def test_main_prints_the_table(h100, tmp_path, capsys):
    with open(tmp_path / "olmoe-1b-7b_train_4k_pod256.json", "w") as f:
        json.dump(_record("olmoe-1b-7b", "train_4k", 2), f)
    roof.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "| olmoe-1b-7b x train_4k |" in out
    assert "worst roofline fraction: olmoe-1b-7b_train_4k_pod256" in out


def test_ideal_over_bound_is_the_fraction_before_its_cap(h100):
    """`ideal_over_bound` recomputes t_useful / t_bound from an `analyse`
    row: min(it, 1) is the row's capped roofline fraction."""
    import itertools
    for arch, shape in itertools.product(("olmoe-1b-7b", "glm4-9b"),
                                         ("train_4k", "decode_32k")):
        row = roof.analyse(_record(arch, shape, 2))
        assert min(roof.ideal_over_bound(row), 1.0) == row["roofline_frac"]

