from ganmf_tpu_torch.data.device import (  # noqa: F401
    DeviceURM,
    PaddedCSR,
    dense_from_sparse,
    padded_csr_from_sparse,
    padded_rows_dense,
    padded_rows_mask,
)
