"""Multi-rank runtime of the port: the counterpart of ganmf_tpu.parallel on
``torch.distributed`` (comm, mesh, distributed), with the sharded epochs of
GANMF (distributed), of DisGANMF, CFGAN and CAAE (adversarial), and the row
layouts through which IALS, MF-SGD and SLIM-BPR train on a mesh (baselines)."""

from ganmf_tpu_torch.parallel.mesh import MeshPlan, make_mesh  # noqa: F401
from ganmf_tpu_torch.parallel.distributed import (  # noqa: F401
    init_distributed,
    make_distributed_ganmf_step,
    shard_caae_params,
    shard_cfgan_params,
    shard_disganmf_params,
    shard_ganmf_params,
    shard_padded_csr,
)
from ganmf_tpu_torch.parallel.baselines import WHOLE, RowShard, Shards  # noqa: F401
from ganmf_tpu_torch.parallel import comm  # noqa: F401
