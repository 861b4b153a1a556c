"""The LM path of the port: configuration, layers, attention, the Mamba2
SSM layer, the dense and ssm transformers, parameter sharding and the
serving loop (prefill and decode), on stacked tensor-parallel ranks."""
