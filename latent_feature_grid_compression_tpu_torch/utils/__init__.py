from .analysis import (load_experiment, collect_experiments, pareto_frontier,
                       fit_log_linear, param_for_target_ratio,
                       targets_from_frontier)
