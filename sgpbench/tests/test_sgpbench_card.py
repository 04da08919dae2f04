"""The tiny copies of BENCHMARK.json's cells on the card: a sound run is
correct and its trace reads the device, the control in the program's
place is not correct. Skips
without an NVIDIA GPU; run on the chip as

    python3 -m pytest sgpbench/tests/test_sgpbench_card.py -m cuda \
        -o addopts= -p no:cacheprovider
"""
import pytest
import torch

import sgpbench_tiny
from test_sgpbench_faults import CONTROL

pytestmark = pytest.mark.cuda


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (CUDA)')
    torch.backends.cuda.matmul.allow_tf32 = False
    return sgpbench_tiny.copy(str(tmp_path_factory.mktemp('bench')))


@pytest.mark.parametrize('cell', ['stamps_k1.batch12288',
                                  'frame410_kl.single'])
def test_cell_on_the_card(root, cell):
    out = sgpbench_tiny.run(root, cell, trace=1, device='cuda')
    assert out['correct'], out['compared']
    assert out['device']['platform'] == 'gpu'
    assert out['device']['busy_s'] > 0 and out['metrics']
    ctl = sgpbench_tiny.run(root, cell, control=CONTROL[cell],
                            device='cuda')
    assert not ctl['correct'], ctl['compared']
