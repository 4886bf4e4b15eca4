"""Placement over meshes of ``torch.distributed`` ranks: the rules
(:mod:`.sharding`), the cross-rank transfers (:mod:`.collectives`) and the
RL population's placement (:mod:`.population`)."""
