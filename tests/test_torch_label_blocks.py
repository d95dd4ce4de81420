"""The memmap echogram's label test without a crop
(``Echogram.labels_any``, ``data/memmap_reader.py``) against the crop's
test it stands for, and the Background sampler's draws through it
(``data/samplers.py``) against the draws the crop's test gives."""

import numpy as np
import pytest

from crimac_unet_tpu_torch.constants import LABEL_BOUNDARY_VAL
from crimac_unet_tpu_torch.data.fixtures import make_survey_dir
from crimac_unet_tpu_torch.data.memmap_reader import Echogram
from crimac_unet_tpu_torch.data.samplers import Background


def _crop_test(ech, center, window):
    labels = ech.crop_labels(center, window)
    return bool(np.any((labels != 0) & (labels != LABEL_BOUNDARY_VAL)))


@pytest.fixture(scope="module")
def echograms(tmp_path_factory):
    """Sides that are not multiples of the label block, and one
    echogram wider than the columns a block table is built from at
    once."""
    root = tmp_path_factory.mktemp("memm")
    dirs = make_survey_dir(root, year=2017, n_echograms=2, H=121, W=301,
                           seed=5, n_schools=6)
    dirs += make_survey_dir(root, year=2018, n_echograms=1, H=40, W=4500,
                            seed=6, n_schools=40)
    return [Echogram(d) for d in dirs]


@pytest.mark.parametrize("window", [(16, 16), (32, 48), (17, 33), (7, 5),
                                    (64, 64), (150, 20), (256, 256)])
def test_labels_any_is_the_crop_test(echograms, window):
    rng = np.random.RandomState(sum(window))
    seen = set()
    for ech in echograms:
        H, W = ech.shape
        for _ in range(400):
            center = [int(rng.randint(-40, H + 40)),
                      int(rng.randint(-40, W + 40))]
            want = _crop_test(ech, center, window)
            seen.add(want)
            assert ech.labels_any(center, window) == want, (ech.name, center)
    assert seen == {True, False}


def _crop_background(sampler, rng):
    """Background's draw by the crop's test: its candidates, rejected
    while their label crop holds fish, 200 at most."""
    for _ in range(200):
        center, ech = sampler._candidate(rng)
        if not _crop_test(ech, center, sampler.window_size):
            break
    return center, ech


@pytest.mark.parametrize("window", [(32, 32), (64, 96)])
def test_background_draws_as_through_the_crop(echograms, window):
    sampler = Background(echograms[:2], window)
    r1, r2 = np.random.RandomState(9), np.random.RandomState(9)
    for _ in range(200):
        (c1, e1), (c2, e2) = sampler.get_sample(r1), \
            _crop_background(sampler, r2)
        assert c1 == c2 and e1 is e2
