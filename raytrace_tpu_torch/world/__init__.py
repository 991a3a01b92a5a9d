"""World math on tensors: noise, heights, material bands, voxel boxes,
the minefield and edits."""
