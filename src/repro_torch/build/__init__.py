from repro_torch.build.planner import (BuildError, BuildPlan, ShardSpec,
                                      build_pyramid_index_parallel,
                                      build_subgraphs, plan_build,
                                      shard_specs)

__all__ = ["BuildError", "BuildPlan", "ShardSpec",
           "build_pyramid_index_parallel", "build_subgraphs", "plan_build",
           "shard_specs"]
