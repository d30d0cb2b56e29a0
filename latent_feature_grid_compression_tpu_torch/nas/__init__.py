from .search import (run_search, MultiObjectiveSearch, pareto_front,
                     hypervolume_2d, Trial, ParamSpec,
                     SMALLIFY_SPACE, BASELINE_SPACE, VARIATIONAL_SPACE)
from .bayesopt import GPEHVIGenerator
