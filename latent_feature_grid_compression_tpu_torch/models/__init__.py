from .feature_grid import (ModelSpec, Params, FeatureGridModel, make_spec,
                           init_model, apply_model, decode_volume,
                           save_dropvalues_on_grid, remove_drop_layers,
                           num_net_params)
