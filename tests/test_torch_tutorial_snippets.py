"""docs/TUTORIAL_TORCH.md stays honest: every ```python block runs as
written, in order, in ONE shared namespace, on the CPU.

Only two things change, as ``tests/test_tutorial_snippets.py`` does for
the JAX tutorial: the synthetic-data constructors are patched to smaller
sizes, and the device that the first block names becomes the CPU. Every
other line runs verbatim, so any API drift (renamed keywords, moved
symbols, changed returns) fails this test. Nothing is read from outside
the checkout: section 6 writes the PSF model it reads back.
"""
import re

import numpy as np
import pytest
import torch

from _torch_source_pin import REPO

TUTORIAL = REPO / 'docs' / 'TUTORIAL_TORCH.md'
DEVICE_LINE = "device = 'cuda'"


def _python_blocks(text):
    return re.findall(r'```python\n(.*?)```', text, re.DOTALL)


@pytest.fixture(autouse=True)
def _one_thread_no_subnormals():
    """Torch and BLAS on one thread, and float32 subnormals flushed to
    zero, as in ``tests/test_torch_examples.py`` (section 6's PSF fit
    makes many small least-squares solves)."""
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    with threadpool_limits(limits=1, user_api='blas'):
        yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(n)


def test_tutorial_python_blocks_run(tmp_path, monkeypatch):
    blocks = _python_blocks(TUTORIAL.read_text())
    assert len(blocks) >= 8
    assert blocks[0].count(DEVICE_LINE) == 1
    blocks[0] = blocks[0].replace(DEVICE_LINE, "device = 'cpu'")
    assert not any(DEVICE_LINE in b for b in blocks[1:])

    import tpu_sgp_torch.simulate as simulate
    real_stamps, real_field = (simulate.synthetic_star_stamps,
                               simulate.synthetic_star_field)

    def small_stamps(n, *a, **kw):
        return real_stamps(min(n, 64), *a, **kw)

    def small_field(h, w, n_stars=200, **kw):
        # section 6 fits a PSF model to this field: 256x256 of 30 stars
        # leaves it six isolated stars (128x128 of 20 leaves none)
        return real_field(min(h, 256), min(w, 256),
                          n_stars=min(n_stars, 30), **kw)

    monkeypatch.setattr(simulate, 'synthetic_star_stamps', small_stamps)
    monkeypatch.setattr(simulate, 'synthetic_star_field', small_field)
    monkeypatch.chdir(tmp_path)        # section 6 and 8 write files here

    import torch.distributed as dist
    ns = {}
    try:
        for i, block in enumerate(blocks):
            try:
                exec(compile(block, f'<tutorial block {i}>', 'exec'), ns)
            except Exception as exc:  # pragma: no cover - failure reporting
                raise AssertionError(
                    f'tutorial block {i} failed: {exc}\n---\n{block}') from exc
    finally:
        if dist.is_initialized():      # a block failed before section 5's
            dist.destroy_process_group()   # own teardown

    # the narrative really solved things along the way
    assert ns['device'] == 'cpu' and ns['x'].shape == ns['gn'].shape
    assert int(ns['res'].iters[0]) > 0          # section 8 solve_with_state
    assert ns['res2'].x.shape == ns['res'].x.shape
    torch.testing.assert_close(ns['res2'].x, ns['res'].x, rtol=0, atol=0)
    assert (tmp_path / 'ckpt.npz').exists()
    assert len(ns['table']) >= 1                # section 6 catalog
    assert ns['psf_mat'].shape == (31, 31)
    assert abs(float(np.sum(ns['psf_mat'])) - 1.0) < 1e-9
    assert ns['mosaic'].shape == (512, 512)
    assert len(ns['stars']) >= 1
    assert not dist.is_initialized()            # section 5 tore its world down
