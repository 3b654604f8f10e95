from repro_torch.graph.graph import Graph  # noqa: F401
from repro_torch.graph.partition import (Partition,  # noqa: F401
                                         PartitionSet, partition_graph)
from repro_torch.graph.sampling import (MinibatchBlocks,  # noqa: F401
                                        epoch_minibatches, layer_capacities,
                                        pad_schedule, sample_blocks)
from repro_torch.graph.synthetic import synthetic_graph  # noqa: F401
