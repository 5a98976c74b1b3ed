"""The port's roofline model (`repro_torch.launch.roofline`) against the
JAX package's, with JAX's module constants set to the H100's data-sheet
values for the test (the JAX files are not changed): on synthetic
dry-run records of every (arch x shape) cell, `_arch_bytes`,
`model_flops`, `analyse`, `to_markdown` and `to_csv` give the same
numbers and text, except where the port departs on purpose: its
collective term is each rank's wire bytes by kind and mesh axis over the
link that axis crosses (`collective_seconds`), where JAX's divides the
per-rank bytes once more by the chip count, so the collective seconds,
the dominant term and the fraction may differ; and each row, and the
tables' last column, carry the fraction before its cap."""
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
           "collective_bytes": 3e9 * (i % 5), "collective_ops": 10 * i,
           "mesh_axes": ["data", "model"],
           "collective_axes": {
               "all-gather over data": {"ops": i, "bytes": 2e9 * (i % 5)},
               "all-reduce over model": {"ops": i, "bytes": 1e9 * (i % 5)}}}
    rec.update(kw)
    return rec


CELLS = [(a, s) for a in list_archs() for s in SHAPE_ORDER]
# the keys of an `analyse` row in which the port departs from JAX
DEPARTS = ("collective_s", "dominant", "roofline_frac", "ideal_over_bound")


def _same_as_jax(row, jrow, rec):
    """Every key of JAX's row equal, but the collective term's own: the
    port's is `collective_seconds`, and its dominant term and fraction
    follow from it."""
    assert set(row) - set(jrow) == {"ideal_over_bound"}
    assert {k: v for k, v in row.items() if k not in DEPARTS} == \
        {k: v for k, v in jrow.items() if k not in DEPARTS}
    assert row["collective_s"] == roof.collective_seconds(rec)
    terms = {k: row[f"{k}_s"] for k in ("compute", "memory", "collective")}
    assert row["dominant"] == max(terms, key=terms.get)
    assert row["roofline_frac"] == min(row["ideal_over_bound"], 1.0)


def test_constants_are_the_h100s():
    assert (roof.PEAK_FLOPS_BF16, roof.HBM_BW, M.LINK_BW,
            M.POD_LINK_BW) == (989e12, 3.35e12, 450e9, 50e9)
    assert [M.link_bw(a) for a in ("data", "model", "data+model", "pod",
                                   "pod+data+model")] == \
        [450e9, 450e9, 450e9, 50e9, 50e9]
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
        _same_as_jax(roof.analyse(rec), jroof.analyse(rec), rec)
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
    jrows = [jroof.analyse(r) for r in recs]
    assert rows[-1] is None and jrows[-1] is None and all(rows[:-1])
    for row, jrow, rec in zip(rows[:-1], jrows[:-1], recs):
        _same_as_jax(row, jrow, rec)
    rows = rows[:-1]
    # the port's tables are JAX's tables of the port's rows, plus the
    # uncapped fraction as the last column
    md = roof.to_markdown(rows).splitlines()
    assert md[0].endswith(" uncapped |") and md[1].endswith("---|---|")
    assert [md[0].rsplit(" |", 2)[0] + " |", md[1][:-4]] + [
        line.rsplit(" |", 2)[0] + " |" for line in md[2:]] == \
        jroof.to_markdown(rows).splitlines()
    assert [line.rsplit(",", 1)[0] for line in
            roof.to_csv(rows).splitlines()] == \
        jroof.to_csv(rows).splitlines()
    for r in recs:
        with open(tmp_path / f"{r['cell']}.json", "w") as f:
            json.dump(r, f)
    assert roof.load_all(str(tmp_path)) == sorted(
        rows, key=lambda r: r["cell"])
    assert [r["cell"] for r in roof.load_all(str(tmp_path))] == \
        [r["cell"] for r in jroof.load_all(str(tmp_path))]
    assert len(roof.load_all(str(tmp_path))) == 33


def test_main_prints_the_table(h100, tmp_path, capsys):
    with open(tmp_path / "olmoe-1b-7b_train_4k_pod256.json", "w") as f:
        json.dump(_record("olmoe-1b-7b", "train_4k", 2), f)
    roof.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "| olmoe-1b-7b x train_4k |" in out
    assert "worst roofline fraction: olmoe-1b-7b_train_4k_pod256" in out


def test_ideal_over_bound_is_the_fraction_before_its_cap(h100):
    """A row's `ideal_over_bound` is t_useful / t_bound, and min(it, 1) is
    its capped roofline fraction."""
    import itertools
    for arch, shape in itertools.product(("olmoe-1b-7b", "glm4-9b"),
                                         ("train_4k", "decode_32k")):
        row = roof.analyse(_record(arch, shape, 2))
        t_bound = max(row["compute_s"], row["memory_s"], row["collective_s"])
        t_ideal = max(row["model_flops"] / (256 * M.PEAK_FLOPS_BF16),
                      row["minimal_bytes_dev"] / M.HBM_BW)
        assert row["ideal_over_bound"] == t_ideal / t_bound
        assert min(row["ideal_over_bound"], 1.0) == row["roofline_frac"]


def test_collective_term_is_wire_bytes_over_the_axis_link(h100):
    """Per rank, a ring all-gather on n ranks receives n - 1 operands, a
    reduce-scatter sends (n - 1) / n of its operand and an all-reduce
    twice that, each over its axis's link: NVLink (450 GB/s) on "data" /
    "model", InfiniBand (50 GB/s) on "pod". JAX's term for the same
    record is the operand bytes over chips x link: 512 x 16 times less
    for the all-gather over data alone."""
    rec = _record("glm4-9b", "train_4k", 0, mesh=[2, 16, 16],
                  chips=512, mesh_axes=["pod", "data", "model"],
                  collective_bytes=7e9, collective_axes={
                      "all-gather over data": {"ops": 3, "bytes": 1e9},
                      "reduce-scatter over data": {"ops": 3, "bytes": 2e9},
                      "all-reduce over model": {"ops": 2, "bytes": 3e9},
                      "all-reduce over pod": {"ops": 1, "bytes": 1e9}})
    want = (1e9 * 15 / 450e9 + 2e9 * 15 / 16 / 450e9
            + 3e9 * 2 * 15 / 16 / 450e9 + 1e9 * 2 * 1 / 2 / 50e9)
    assert roof.collective_seconds(rec) == pytest.approx(want, rel=1e-12)
    assert roof.analyse(rec)["collective_s"] == roof.collective_seconds(rec)
    assert jroof.analyse(rec)["collective_s"] == 7e9 / (512 * M.LINK_BW)

