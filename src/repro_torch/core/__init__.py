"""ECORE core: profile state/table, Algorithm 1 and the baseline routers,
estimators, the closed loop and the gateway."""
from .groups import DEFAULT_GROUP_RULES, group_of  # noqa: F401
from .profiles import (ProfileArrays, ProfileEntry, ProfileState,  # noqa: F401
                       ProfileTable, add_pair, observe_state, retire_pair)
from .router import (BASELINE_ROUTERS, GreedyEstimateRouter,  # noqa: F401
                     HighestMAPPerGroupRouter, HighestMAPRouter,
                     LowestEnergyRouter, LowestInferenceRouter, OracleRouter,
                     ParetoRouter, RandomRouter, RoundRobinRouter,
                     WeightedRouter, decide_state, feasible_for_count,
                     feasible_set, greedy_route, pareto_front, route_batch,
                     runner_up_route)
from .closed_loop import (ScanDecisions, StreamMeasurements,  # noqa: F401
                          scan_stream)
from .estimators import (EdgeDetectionEstimator,  # noqa: F401
                         OracleEstimator, OutputBasedEstimator,
                         SSDFrontEndEstimator)
from .policy import (DetectionPolicy, Observation, PoolPolicy,  # noqa: F401
                     RouteDecision, RouteRequest)
from .gateway import EpisodeStats, Gateway  # noqa: F401
