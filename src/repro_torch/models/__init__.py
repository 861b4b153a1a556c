"""The LM path of the port: configuration, layers, attention, the dense
transformer, parameter sharding and the serving loop (prefill and decode),
on stacked tensor-parallel ranks."""
