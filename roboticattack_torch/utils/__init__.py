"""Host-side helpers of the PyTorch port: constants, action tokens, image
normalization, prompting and the --quantize grammar."""
