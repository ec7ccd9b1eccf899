"""The port's arch registry (`repro_torch.configs.registry`, `configs.base`
and each config module's `cells`) against the JAX package's
(`repro.configs.registry`), and the launchers resolving `--arch` through
it."""
import dataclasses

import pytest

from repro.configs import registry as ref_registry
from repro_torch import configs as port_configs
from repro_torch.configs import qwen3_moe_235b, registry
from repro_torch.configs.base import Cell
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train

FIELDS = ("shape", "kind", "skip_reason", "extra")


def _rows(cells) -> list:
    return [(name,) + tuple(getattr(c, f) for f in FIELDS)
            for name, c in cells]


def test_tables_match_reference():
    assert list(registry.ARCHS) == list(ref_registry.ARCHS)
    assert list(registry.EXTRA_ARCHS) == list(ref_registry.EXTRA_ARCHS)
    assert list(registry.ALL_ARCHS) == list(ref_registry.ALL_ARCHS)
    assert port_configs.get is registry.get
    assert port_configs.all_cells is registry.all_cells


@pytest.mark.parametrize("include_extra", [True, False])
def test_all_cells_match_reference_field_by_field(include_extra):
    got = _rows(registry.all_cells(include_extra))
    assert got == _rows(ref_registry.all_cells(include_extra))
    assert len(got) == (47 if include_extra else 41)


@pytest.mark.parametrize("arch", list(ref_registry.ALL_ARCHS))
def test_each_arch_resolves_to_its_port_module(arch):
    mod = registry.get(arch)
    assert mod.__name__.startswith("repro_torch.configs.")
    assert mod.NAME == arch == ref_registry.get(arch).NAME
    assert mod.FAMILY == ref_registry.get(arch).FAMILY
    assert all(isinstance(c, Cell) for c in mod.cells())
    assert [dataclasses.astuple(c) for c in mod.cells()] == \
        [dataclasses.astuple(c) for c in ref_registry.get(arch).cells()]


def test_unknown_arch_raises_the_same_key_error():
    with pytest.raises(KeyError) as ref_err:
        ref_registry.get("no-such-arch")
    with pytest.raises(KeyError) as port_err:
        registry.get("no-such-arch")
    assert str(port_err.value) == str(ref_err.value)


class TestLaunchers:
    def test_tables_are_gone(self):
        assert not hasattr(launch_train, "ARCHS")
        assert not hasattr(launch_serve, "ARCHS")
        assert launch_train.get is registry.get
        assert launch_serve.get is registry.get

    @pytest.mark.parametrize("launcher", [launch_train, launch_serve])
    def test_unknown_arch_raises_key_error(self, launcher):
        with pytest.raises(KeyError, match="unknown arch 'no-such-arch'"):
            launcher.main(["--arch", "no-such-arch", "--device", "cpu"])

    @pytest.mark.parametrize("arch", ["pna", "dlrm-rm2", "cpaa-pagerank"])
    def test_serve_rejects_what_it_cannot_serve(self, arch):
        with pytest.raises(SystemExit, match="is not servable"):
            launch_serve.main(["--arch", arch, "--device", "cpu"])

    def test_train_resolves_through_registry(self, monkeypatch):
        """A name registered only in the registry reaches the launcher."""
        seen = []

        def get(name):
            seen.append(name)
            return registry.get("pna")
        monkeypatch.setattr(launch_train, "get", get)
        with pytest.raises(SystemExit, match="drives LM archs"):
            launch_train.main(["--arch", "registered-elsewhere",
                               "--device", "cpu"])
        assert seen == ["registered-elsewhere"]


class TestQwen3A2aCell:
    def test_train_4k_a2a_config(self):
        cfg, shape = qwen3_moe_235b.cell_config("train_4k_a2a")
        full = qwen3_moe_235b.full_config()
        assert shape == "train_4k"
        assert cfg.moe.impl == "a2a" and full.moe.impl == "dense"
        assert dataclasses.replace(cfg, moe=full.moe) == full
        assert dataclasses.replace(cfg.moe, impl="dense") == full.moe

    @pytest.mark.parametrize("shape", ["train_4k", "prefill_32k",
                                       "decode_32k", "long_500k"])
    def test_assigned_cells_keep_full_config(self, shape):
        assert qwen3_moe_235b.cell_config(shape) == \
            (qwen3_moe_235b.full_config(), shape)

    def test_extra_cell_listed(self):
        extra = [c for c in registry.get("qwen3-moe-235b-a22b").cells()
                 if c.extra]
        assert extra == [Cell(shape="train_4k_a2a", kind="train",
                              extra=True)]
