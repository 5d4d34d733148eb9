"""Host input pipeline: manifests, transforms, the native decoder,
batching, the datamodules, the pinned-memory placer, and the on-device
dequantize of the uint8 wire format.

  manifests.py     ← pickle manifest readers, the CSV corpus manifest
  transforms.py    ← PIL image/clip stacks, AutoAugment, erasing,
                     expert augmentation
  native.py        ← ctypes loader of native/devt_host.cpp (JPEG/PNG/MJPEG)
  mmx_frame.py     ← dataloaders/mmx/MMX_Frame_dl.py, MMX_Light_dl.py
  mmx_temporal.py  ← dataloaders/mmx/MMX_Temporal_dl.py (expert sequences)
  mit_temporal.py  ← dataloaders/mit/MIT_Temporal_dl.py
  contrastive.py   ← dataloaders mmx/mit *_Contrastive_dl.py (pair sampling)
  samplers.py      ← WeightedRandomSampler equivalent
  synthetic.py     ← synthetic batches, fake expert and frame corpora
  pipeline.py      ← batching, per-host sharding, pinned device placement
  loader_adapter.py ← the datasets under torch.utils.data.DataLoader
  device_norm.py   ← the u8 wire's dequantize on the device
"""
