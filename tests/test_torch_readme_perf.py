"""The port's readme_perf against the reference's.

`render` of the committed BENCH_r01-r12 series equals the reference's,
as a whole and for each artifact alone (what `--bench` renders); an
artifact measured on an NVIDIA card (`platform_of` = `gpu`) renders
chip-pinned, tagged `· gpu`, its arrows against earlier card artifacts
only; `main` writes and checks the port's own README block, which renders
card artifacts alone and states no figure while the series has none.
"""
import re
import shutil

import pytest

from foundationdb_tpu.tools import readme_perf as jrp
from foundationdb_tpu_torch.tools import bench_history as tbh
from foundationdb_tpu_torch.tools import readme_perf as trp

ROOT = trp.find_repo_root()
CARD = "NVIDIA H100 80GB HBM3"


def series():
    return trp.load_artifacts(ROOT)


def card_artifact(name, scale=1.0):
    """A parsed BENCH_r05.json as if measured on the card, its headline
    value scaled by `scale`."""
    parsed = dict(tbh.load_parsed(ROOT / "BENCH_r05.json"), device=CARD)
    parsed["value"] = parsed["value"] * scale
    return name, parsed


def test_repo_root_and_series_equal_the_reference():
    assert ROOT == jrp.find_repo_root()
    assert [n for n, _ in series()] == [n for n, _ in jrp.load_artifacts(ROOT)]
    assert [n for n, _ in series()] == [f"BENCH_r{i:02d}.json" for i in range(1, 13)]


def test_render_of_the_committed_series_equals_the_reference():
    arts = series()
    assert trp.render(arts) == jrp.render(arts)


@pytest.mark.parametrize("name", [f"BENCH_r{i:02d}.json" for i in range(1, 13)])
def test_render_of_each_artifact_alone_equals_the_reference(name):
    art = [(name, tbh.load_parsed(ROOT / name))]
    try:
        want = jrp.render(art)
    except KeyError as e:
        # r01 and r02 predate a key their headline bullet reads: the
        # reference raises on them alone, and so does the port
        with pytest.raises(KeyError) as got:
            trp.render(art)
        assert got.value.args == e.args
        return
    assert trp.render(art) == want


def test_card_artifact_is_chip_pinned_and_tagged_gpu():
    arts = series() + [card_artifact("BENCH_r13.json")]
    block = trp.render(arts)
    head = next(line for line in block.splitlines() if line.startswith("- single chip"))
    # the newest accelerator artifact carries the headline, with no arrow:
    # no earlier card artifact, and a TPU round never trends against it
    assert head.endswith("*(r13 · gpu)*") and "vs r" not in head
    assert "BENCH_r13.json [gpu]" in block
    # the CPU rounds' sections keep their cpu tags
    assert "· cpu)*" in block


def test_card_arrows_compare_only_with_an_earlier_card_artifact():
    arts = series() + [card_artifact("BENCH_r13.json"), card_artifact("BENCH_r14.json", 1.1)]
    head = next(line for line in trp.render(arts).splitlines()
                if line.startswith("- single chip"))
    assert head.endswith("— ↑ +10.0% vs r13 *(r14 · gpu)*")
    # a card artifact between two TPU rounds: the later TPU round's arrow
    # skips it and compares with the earlier TPU round
    arts = series()
    mixed = arts[:4] + [card_artifact("BENCH_r04b.json", 0.5)] + [arts[4]]
    head = next(line for line in trp.render(mixed).splitlines()
                if line.startswith("- single chip"))
    want = next(line for line in jrp.render(arts[:5]).splitlines()
                if line.startswith("- single chip"))
    assert head == want and "vs r04" in head


def test_port_block_renders_card_artifacts_alone():
    assert trp.render_port(series()) == "\n".join([
        trp.TORCH_BEGIN,
        "<!-- generated by foundationdb_tpu_torch/tools/readme_perf.py from no gpu artifact; "
        "edit there -->",
        trp.NO_CARD_ARTIFACT,
        trp.TORCH_END])
    card = card_artifact("BENCH_r13.json")
    block = trp.render_port(series() + [card])
    assert block == trp.render_port([card])
    assert "BENCH_r13.json [gpu]" in block and "[tpu]" not in block and "[cpu]" not in block
    assert all(line.endswith("*(r13 · gpu)*") for line in block.splitlines()
               if line.startswith("- "))


def test_port_block_states_no_figure_without_a_card_artifact():
    block = trp.render_port(series())
    assert not re.search(r"\d", block.replace("BENCH_r*", "")), block
    text = (ROOT / "README.md").read_text()
    committed = text[text.index(trp.TORCH_BEGIN):text.index(trp.TORCH_END) + len(trp.TORCH_END)]
    assert committed == block
    # the port's block sits in README's section on the port, before the
    # reference's block
    assert text.index("## The PyTorch / CUDA port") < text.index(trp.TORCH_BEGIN) \
        < text.index(jrp.BEGIN)


def test_check_passes_on_the_committed_readme(capsys):
    assert trp.main(["--check"]) == 0
    assert "matches BENCH_r12.json" in capsys.readouterr().out
    # and the reference's own block is untouched by the port's
    assert jrp.main(["--check"]) == 0


def test_check_fails_on_a_stale_port_block(tmp_path, capsys):
    readme = tmp_path / "README.md"
    text = (ROOT / "README.md").read_text()
    stale = text.replace(trp.NO_CARD_ARTIFACT, "- single chip: **9.99M resolved txn/s**")
    assert stale != text
    readme.write_text(stale)
    assert trp.main(["--check", "--readme", str(readme)]) == 1
    assert "stale" in capsys.readouterr().out
    assert readme.read_text() == stale


def test_main_rewrites_the_port_block_and_only_it(tmp_path):
    readme = tmp_path / "README.md"
    text = (ROOT / "README.md").read_text()
    begin, end = text.index(trp.TORCH_BEGIN), text.index(trp.TORCH_END) + len(trp.TORCH_END)
    emptied = text[:begin] + trp.TORCH_BEGIN + "\n" + trp.TORCH_END + text[end:]
    readme.write_text(emptied)
    assert trp.main(["--readme", str(readme)]) == 0
    assert readme.read_text() == text
    assert trp.main(["--check", "--readme", str(readme)]) == 0


def test_bench_renders_one_artifact_into_the_port_block(tmp_path):
    art = tmp_path / "BENCH_r13.json"
    shutil.copy(ROOT / "BENCH_r05.json", art)
    readme = tmp_path / "README.md"
    readme.write_text((ROOT / "README.md").read_text())
    # a TPU artifact alone: the port's block is the no-card line
    assert trp.main(["--check", "--bench", str(art), "--readme", str(readme)]) == 0
    text = art.read_text().replace('"device": "TPU v5 lite0"', f'"device": "{CARD}"')
    assert CARD in text
    art.write_text(text)
    assert trp.main(["--check", "--bench", str(art), "--readme", str(readme)]) == 1
    assert trp.main(["--bench", str(art), "--readme", str(readme)]) == 0
    assert trp.render_port([("BENCH_r13.json", tbh.load_parsed(art))]) in readme.read_text()


def test_readme_without_the_port_markers_is_refused(tmp_path):
    readme = tmp_path / "README.md"
    readme.write_text("# no block\n")
    with pytest.raises(SystemExit):
        trp.main(["--check", "--readme", str(readme)])
