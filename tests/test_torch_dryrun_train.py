"""The port's dry-run train cells against the reference's: per-device
bytes of train_4k at each family's smoke config on the 16 x 16 mesh, one
on the 2 x 16 x 16 mesh, one with `--compress` (the error residuals on
the moments' specs) and one with `--no-zero1`, against XLA's
memory_analysis() of the reference's compiled step (the arguments byte
for byte, the outputs less XLA's 8-byte tuple index per output leaf).

The reference runs in one subprocess for this module
(`_dryrun_reference.py`); `test_torch_dryrun.py` holds the serving
cells.
"""
import pytest

from _dryrun_cells import FAMILY_ARCHS, ask_reference, check_memory

TRAIN_CELLS = ([[arch, "train_4k", "single", False, True]
                for arch in FAMILY_ARCHS]
               + [["zamba2-1.2b", "train_4k", "multi", False, True],
                  ["qwen3-14b", "train_4k", "single", True, True],
                  ["deepseek-v3-671b", "train_4k", "single", False,
                   False]])


@pytest.fixture(scope="module")
def ref():
    return ask_reference({"cells": TRAIN_CELLS})


@pytest.mark.parametrize("cell", TRAIN_CELLS,
                         ids=lambda c: "-".join(map(str, c)))
def test_train_cell_memory_equals_xla(ref, cell):
    check_memory(ref, cell)


def test_zero1_and_compress_change_the_bytes(ref):
    """The two variants are not the base cell under another name: ZeRO-1
    cuts the moments over "data" and --compress adds the residuals."""
    def arg_b(cell):
        return ref["cells"]["|".join(map(str, cell))]["argument_b"]
    assert arg_b(["deepseek-v3-671b", "train_4k", "single", False, False]) \
        > arg_b(["deepseek-v3-671b", "train_4k", "single", False, True])
    assert arg_b(["qwen3-14b", "train_4k", "single", True, True]) \
        > arg_b(["qwen3-14b", "train_4k", "single", False, True])
