"""The served cell's control on the CPU, at a size where its numbers fall
as at full size (`configs/chatglm3-6b.py` `CONTROL`): the program's
served tokens lie within the cell's limit of the fp32 reference, and the
tokens that the fp8 reference puts first do not."""
import pytest
import torch

from portbench import bench, gen

BM = bench.load_benchmark()
CELL = "chatglm3-6b.chat"


@pytest.fixture(autouse=True)
def one_thread():
    """Toy sizes run fastest on one thread, and leave the other workers
    their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_fp8_control_fails_where_the_program_passes(seed):
    cell, _ = bench.make_cell(BM, CELL, seed, "cpu")
    conf = next(c for c in BM["configs"] if c["name"] == cell["config"])
    mod = bench.load_module(bench.HERE / "configs" / f"{conf['name']}.py")
    spec = __import__("json").loads((bench.ROOT / conf["file"]).read_text())
    mix = dict(gen.load_mix(cell["traffic"]), **mod.CONTROL["mix"])
    c = mod.make(spec, mix, seed, "cpu", small=mod.CONTROL)
    c.setup(1.0)
    c.run(1.0, False)
    limit = spec["check"]["served_gap_limit"]
    g = c.gaps(fp8=True)
    assert g["served_tokens"] >= 200
    assert g["served_gap"] <= limit < g["control_gap"], g
