"""The port's dataset layer (beach_seg_tpu_torch.data) against the JAX
package's on the synthetic scene: scenes, dataset items, padded batches and
prompts bit-equal."""

import dataclasses

import numpy as np
import pytest

from beach_seg_tpu.config import BeachSegConfig as JConf
from beach_seg_tpu.data import dataset as jdata
from beach_seg_tpu_torch.config import BeachSegConfig
from beach_seg_tpu_torch.data import dataset as pdata
from beach_seg_tpu_torch.data.prefetch import MosaicPrefetcher, prefetch_iterator
from tests.synthetic_scene import MASK_DATE, OTHER_DATES, build_scene

SIZES = dict(crop_size=32, inpt_size=64)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return build_scene(tmp_path_factory.mktemp("data_scene"))


@pytest.fixture(scope="module")
def confs(scene_dir):
    return JConf(data=scene_dir, **SIZES), BeachSegConfig(data=scene_dir, **SIZES)


@pytest.fixture(scope="module", params=[True, False], ids=["train", "predict"])
def scenes(request, confs):
    jconf, conf = confs
    return jdata.create_scene(jconf, train=request.param), pdata.create_scene(conf, train=request.param)


def _assert_equal_items(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k == "date":
            assert list(np.atleast_1d(got[k])) == list(np.atleast_1d(v))
        else:
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_create_scene_matches_jax(scenes):
    want, got = scenes
    assert got.crops == want.crops and len(want.crops) > 2
    assert got.out_transform.to_tuple() == want.out_transform.to_tuple()
    assert (got.out_shape, got.crs, got.mask_date) == (want.out_shape, want.crs, want.mask_date)
    assert sorted(got.date_merged_imgs) == sorted(want.date_merged_imgs)
    assert set(want.date_merged_imgs) in ({MASK_DATE}, set(OTHER_DATES))
    for date, (img, nodata) in want.date_merged_imgs.items():
        np.testing.assert_array_equal(got.date_merged_imgs[date][0], img)
        np.testing.assert_array_equal(got.date_merged_imgs[date][1], nodata)
    for date, mask in want.date_masks.items():
        np.testing.assert_array_equal(got.date_masks[date], mask)
    assert len(np.unique(want.date_masks[MASK_DATE])) == 4


@pytest.mark.parametrize("raw", [True, False], ids=["raw", "resized"])
def test_dataset_items_match_jax(scenes, confs, raw):
    jscene, scene = scenes
    jconf, conf = confs
    want, got = jdata.BeachSegDataset(jscene, jconf, raw=raw), pdata.BeachSegDataset(scene, conf, raw=raw)
    assert got.items == want.items and len(want) > 0
    for i in range(len(want)):
        _assert_equal_items(got[i], want[i])


@pytest.mark.parametrize("workers", [0, 2])
def test_iterate_batches_match_jax(scenes, confs, workers):
    """Batches of 3 over the raw dataset: the last one padded by repeating
    its last item, ``valid`` marking the real rows."""
    jscene, scene = scenes
    jconf, conf = confs
    want = list(jdata.iterate_batches(jdata.BeachSegDataset(jscene, jconf, raw=True), 3, workers=workers))
    got = list(pdata.iterate_batches(pdata.BeachSegDataset(scene, conf, raw=True), 3, workers=workers))
    assert len(got) == len(want)
    assert not want[-1]["valid"].all()  # the ragged tail is padded
    for g, w in zip(got, want):
        _assert_equal_items(g, w)


def test_materialize_prompts_match_jax(confs):
    """The prompts come from the reference date of the train scene."""
    jscene, scene = jdata.create_scene(confs[0], train=True), pdata.create_scene(confs[1], train=True)
    want = jdata.materialize_prompts(jscene, confs[0])
    got = pdata.materialize_prompts(scene, confs[1])
    _assert_equal_items(got, want)
    assert got["pixels"].shape == (len(scene.crops), 64, 64, 3)


def test_prefetchers_deliver_in_order(scenes, confs):
    """MosaicPrefetcher yields every date's merge in order; prefetch_iterator
    re-raises the producer's exception in the consumer."""
    _, scene = scenes
    dates = [(d, [d]) for d in ("a", "b", "c", "d")]
    got = list(MosaicPrefetcher(dates, lambda paths: paths[0] * 2, ahead=1))
    assert got == [("a", "aa"), ("b", "bb"), ("c", "cc"), ("d", "dd")]

    def boom():
        yield dataclasses.replace(scene)
        raise ValueError("producer failed")

    it = prefetch_iterator(boom())
    assert next(it).crops == scene.crops
    with pytest.raises(ValueError, match="producer failed"):
        next(it)


def test_mosaic_prefetcher_spawn_pool_matches_threads(scene_dir, confs):
    """The subprocess-merge path: spawned interpreters import the port's geo
    and load the native library that the parent built, and deliver the same
    mosaics as the thread pool."""
    import functools

    from beach_seg_tpu_torch.geo.extent import group_images_by_date
    from beach_seg_tpu_torch.geo.mosaic import merge_tifs

    scene = pdata.create_scene(confs[1], train=True)
    groups = sorted(group_images_by_date(list((scene_dir / "SatelliteImagery").glob("*/*.tif"))).items())
    merge = functools.partial(merge_tifs, out_shape=scene.out_shape, out_transform=scene.out_transform, crs=scene.crs)
    threads = list(MosaicPrefetcher(groups, merge, processes=False))
    procs = list(MosaicPrefetcher(groups, merge, processes=True, workers=2))
    assert [d for d, _ in procs] == [d for d, _ in threads] == [d for d, _ in groups]
    for (_, (img_t, nod_t)), (_, (img_p, nod_p)) in zip(threads, procs):
        np.testing.assert_array_equal(img_p, img_t)
        np.testing.assert_array_equal(nod_p, nod_t)
