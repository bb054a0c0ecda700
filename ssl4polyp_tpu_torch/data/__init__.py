"""The data engine: pack indices, host-side decode, device-side augmentation.

* Host (:mod:`.packs`, :mod:`.transforms`, :mod:`.loader`; :mod:`.folder`
  for the pretrain corpus): manifest resolution, PIL decode and resize,
  deterministic per-row perturbation rendering, batch assembly as uint8
  numpy arrays, seeded epoch shuffling.
* Device (:mod:`.augment`): the training augmentation chain and the
  normalisation run on the card on uint8 batches.
"""
