"""The port's copy of ``tests/test_elastic_store.py``: the elastic trainer
fleet over the port's bus (``repro_torch.train.elastic`` on the CPU) and
the DICOM store service (Figure 1's last arrow), with the port's lockdep
and racedep armed."""
import numpy as np
import pytest
import torch

from _torch_spine import port_lockdep_armed, port_racedep_armed  # noqa: F401
from _torch_train import one_torch_thread  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.core import SimScheduler, Subscription
from repro_torch.data import TokenDataset
from repro_torch.train import TrainConfig, init_train_state
from repro_torch.train.elastic import ElasticTrainer
from repro_torch.wsi import (ConvertOptions, SyntheticScanner,
                             convert_wsi_to_dicom)
from repro_torch.wsi.store_service import DicomStoreService


@pytest.fixture(scope="module")
def small():
    cfg = get_config("gemma-2b").reduced()
    tc = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    return cfg, tc


def _trainer(cfg, tc, sched, n_workers=2):
    state = init_train_state(cfg, tc, torch.Generator().manual_seed(0),
                             "cpu")
    ds = TokenDataset(cfg.vocab_size, 32, seed=0)
    t = ElasticTrainer(sched, cfg, tc, state,
                       lambda shard: ds.shard_batch(shard, 4))
    for i in range(n_workers):
        t.add_worker(f"w{i}")
    return t


def test_elastic_epoch_applies_every_shard_once(small):
    cfg, tc = small
    sched = SimScheduler()
    t = _trainer(cfg, tc, sched, n_workers=3)
    done = t.run_epoch(n_shards=12)
    assert done == list(range(12))
    assert len(t.losses) == 12  # effectively-once: no duplicate updates


def test_elastic_survives_worker_death(small):
    cfg, tc = small
    sched = SimScheduler()
    t = _trainer(cfg, tc, sched, n_workers=2)
    # kill one worker mid-epoch; its in-flight shard must redeliver
    sched.schedule(15.0, lambda: t.kill_worker("w0"))
    done = t.run_epoch(n_shards=10)
    assert done == list(range(10))
    assert len(t.losses) == 10


def test_elastic_scale_up_mid_epoch(small):
    cfg, tc = small
    sched = SimScheduler()
    t = _trainer(cfg, tc, sched, n_workers=1)
    sched.schedule(25.0, lambda: t.add_worker("late", speed=2.0))
    done = t.run_epoch(n_shards=8)
    assert done == list(range(8))


def test_elastic_loss_decreases(small):
    cfg, tc = small
    sched = SimScheduler()
    t = _trainer(cfg, tc, sched, n_workers=4)
    for epoch in range(3):
        t.run_epoch(n_shards=8, epoch=epoch)
    assert np.mean(t.losses[-6:]) < np.mean(t.losses[:6]) - 0.2


# --------------------------------------------------------------------------
# DICOM store service
# --------------------------------------------------------------------------
def test_store_stow_qido_wado_roundtrip():
    sched = SimScheduler()
    from repro_torch.core.storage import ObjectStore

    store = ObjectStore(sched)
    svc = DicomStoreService(store.bucket("dicom"), sched)
    notified = []
    Subscription(svc.topic, "ml-consumer",
                 lambda m, c: (notified.append(m.data), c.ack()))

    psv = SyntheticScanner(seed=3).scan(512, 512, 256)
    archive = convert_wsi_to_dicom(psv, metadata={"slide_id": "X"},
                                   options=ConvertOptions(device="cpu"))
    sops = svc.store_study_archive("studies/x", archive)
    sched.run()

    assert len(sops) == 2  # two pyramid levels
    studies = svc.search_studies(patient_id="ANON")
    assert len(studies) == 1
    instances = svc.search_instances(studies[0])
    assert {i["total_rows"] for i in instances} == {512, 256}
    # WADO retrieve + frame access
    blob = svc.retrieve(sops[0])
    assert blob[128:132] == b"DICM"
    frame = svc.retrieve_frame(sops[0], 0)
    assert len(frame) > 100
    # downstream consumer got one event per instance (extensibility claim)
    assert len(notified) == 2
    assert all(n["modality"] == "SM" for n in notified)
