"""Command-line entry points (python -m cc_tpu_torch.cli.<name>), the
counterparts of cc_tpu's: train; the depth, pose, flow and mask
benchmarks test_disp, test_make3d, test_pose, test_sintel_pose,
test_back2future, test_flow and test_mask; run_inference; submit_flow;
and evaluate_flow. Each but evaluate_flow (host only) runs on the GPU
unless given --device cpu."""
