"""Evaluation: the composite rigid and non-rigid flow, and the benchmark
frameworks of the eval CLIs (KITTI Eigen depth, stillbox, KITTI odometry,
MPI-Sintel); the counterpart of cc_tpu/eval."""
