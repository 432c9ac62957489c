"""ECORE core: profile state/table, Algorithm 1, estimators, the closed
loop and the gateway."""
from .groups import DEFAULT_GROUP_RULES, group_of  # noqa: F401
from .profiles import (ProfileArrays, ProfileEntry, ProfileState,  # noqa: F401
                       ProfileTable, observe_state)
from .router import (GreedyEstimateRouter, OracleRouter,  # noqa: F401
                     decide_state, greedy_route, route_batch)
from .closed_loop import (ScanDecisions, StreamMeasurements,  # noqa: F401
                          scan_stream)
from .estimators import EdgeDetectionEstimator, OracleEstimator  # noqa: F401
from .policy import (DetectionPolicy, Observation, PoolPolicy,  # noqa: F401
                     RouteDecision, RouteRequest)
from .gateway import EpisodeStats, Gateway  # noqa: F401
