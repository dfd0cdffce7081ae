// The bf16 forms of K2, K4 and K5 (the train step's
// sim_dtype="bfloat16"): interaction_similarity.cu's entries with the `_bf16`
// suffix, built into a library of their own (see that file) so that the
// two libraries' tile kernels compile in parallel.

#define SIMILARITY_BF16_ENTRIES
#include "interaction_similarity.cu"
