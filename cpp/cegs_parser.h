// cegs_parser — native Kaldi NnetChainExample binary ark parser (C ABI).
//
// Native analog of the reference's pure-Go parser
// (ref: /root/reference/internal/parser/{parser,matrix,fst}.go): the hot
// data-ingestion path is native code; Python binds via ctypes and falls
// back to the pure-Python parser when the shared library is absent.
//
// Decode math is bit-faithful to the reference (column-major CM with the
// fp32-multiply/fp64-divide branch-3 quirk, CM2/CM3 row-major linear maps).

#ifndef CEGS_PARSER_H
#define CEGS_PARSER_H

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct CegsParser CegsParser;

// Lifecycle -----------------------------------------------------------------
CegsParser *cegs_open(const char *path);
void cegs_close(CegsParser *p);
const char *cegs_last_error(CegsParser *p);

// Advance to the next example.  Returns 1 on success, 0 at EOF, -1 on error.
int cegs_next(CegsParser *p);

// Current example accessors -------------------------------------------------
const char *cegs_key(CegsParser *p);

int cegs_num_inputs(CegsParser *p);
const char *cegs_input_name(CegsParser *p, int i);
int cegs_input_rows(CegsParser *p, int i);
int cegs_input_cols(CegsParser *p, int i);
const float *cegs_input_data(CegsParser *p, int i);       // row-major
int cegs_input_num_indexes(CegsParser *p, int i);
const int32_t *cegs_input_indexes(CegsParser *p, int i);  // [n, t, x] triples

// Supervision ---------------------------------------------------------------
float cegs_sup_weight(CegsParser *p);
int cegs_sup_num_sequences(CegsParser *p);
int cegs_sup_frames_per_seq(CegsParser *p);
int cegs_sup_label_dim(CegsParser *p);
int cegs_sup_end2end(CegsParser *p);
int cegs_sup_num_indexes(CegsParser *p);
const int32_t *cegs_sup_indexes(CegsParser *p);
int cegs_sup_num_deriv_weights(CegsParser *p);
const float *cegs_sup_deriv_weights(CegsParser *p);
const char *cegs_sup_name(CegsParser *p);       // supervision output name
int cegs_input_fmt(CegsParser *p, int i);       // 0=CM 1=CM2 2=CM3 3=FM
int cegs_dw_fmt(CegsParser *p);                 // 0=none 1=DW 2=DW2

// Supervision FST (flattened arcs) ------------------------------------------
/* packed per-example scalar metadata; see cegs_parser.cpp for the
 * int32 layout.  out must hold >= 32 int32s; returns #written. */
int cegs_meta(CegsParser *p, int32_t *out);
int cegs_fst_num_states(CegsParser *p);
int cegs_fst_start(CegsParser *p);
int cegs_fst_num_arcs(CegsParser *p);
const int32_t *cegs_fst_arc_src(CegsParser *p);
const int32_t *cegs_fst_arc_dst(CegsParser *p);
const int32_t *cegs_fst_arc_label(CegsParser *p);
const float *cegs_fst_arc_weight(CegsParser *p);   // tropical (as stored)
int cegs_fst_num_finals(CegsParser *p);
const int32_t *cegs_fst_final_states(CegsParser *p);
const float *cegs_fst_final_weights(CegsParser *p);

#ifdef __cplusplus
}
#endif

#endif  // CEGS_PARSER_H
