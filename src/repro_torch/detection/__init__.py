"""Detection face: synthetic scenes, the edge-device fleet, the ED
estimator's component counting and the detector family."""
