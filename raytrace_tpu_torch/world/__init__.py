"""World math on tensors: noise, heights and material bands."""
