from llamago_tpu_torch.checkpoint.ggjt import (  # noqa: F401
    GGJT_MAGIC,
    GGJT_VERSION,
    GGJTCheckpoint,
    read_ggjt,
    write_ggjt,
)
from llamago_tpu_torch.checkpoint.gguf import (  # noqa: F401
    read_checkpoint,
    read_gguf,
    write_gguf,
)
from llamago_tpu_torch.checkpoint.params import (  # noqa: F401
    load_parameters,
    random_parameters,
)
