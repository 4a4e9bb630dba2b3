from clipbert_tpu_torch.core.mesh import (DATA_AXIS, MODEL_AXIS, Mesh,
                                          make_mesh)
from clipbert_tpu_torch.parallel.sharding import shard_model, tp_split_dim

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "make_mesh", "shard_model",
           "tp_split_dim"]
