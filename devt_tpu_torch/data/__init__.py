"""Host input pipeline: manifests, batching, datamodules of the embedding
datasets, the pinned-memory placer, and the serving path's on-device
dequantize of the uint8 wire format.

  manifests.py     ← pickle manifest readers (append-streamed pickles)
  transforms.py    ← normalization constants, expert augmentation
  mmx_temporal.py  ← dataloaders/mmx/MMX_Temporal_dl.py (expert sequences)
  mit_temporal.py  ← dataloaders/mit/MIT_Temporal_dl.py
  contrastive.py   ← dataloaders mmx/mit *_Contrastive_dl.py (pair sampling)
  samplers.py      ← WeightedRandomSampler equivalent
  synthetic.py     ← synthetic batches and fake expert corpora
  pipeline.py      ← batching, per-host sharding, pinned device placement
  device_norm.py   ← the u8 wire's dequantize on the device

The frame datasets (``mmx_frame.py``, the PIL transforms, the CSV
manifest) are not ported yet (ROADMAP.md queue 1, item 10).
"""
