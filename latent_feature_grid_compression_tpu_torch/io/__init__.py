from .checkpoint import save_checkpoint, load_checkpoint
from .container import restore_model, read_mask_bnr, store_model_parameters
