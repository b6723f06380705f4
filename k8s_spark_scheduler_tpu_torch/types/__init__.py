from .resources import (
    NodeGroupResources,
    NodeGroupSchedulingMetadata,
    NodeSchedulingMetadata,
    Resources,
)
