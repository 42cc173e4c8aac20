/* amgx_tpu_torch_c.h — C API of the PyTorch port (amgx_tpu_torch).
 *
 * Mirrors the AmgX C API surface (reference include/amgx_c.h) so existing
 * AmgX host codes can switch by relinking: same function names, handle
 * semantics and return codes.  Implemented by embedding the Python
 * runtime (amgx_tpu_torch.api.capi) — see amgx_tpu_torch_c.c.  Entry
 * points the port has not ported yet return AMGX_RC_NOT_IMPLEMENTED.
 */

#ifndef AMGX_TPU_TORCH_C_H
#define AMGX_TPU_TORCH_C_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Exact reference enum values (amgx_c.h:52-69); THRUST_FAILURE and
 * NO_MEMORY are placeholders kept so every later code matches. */
typedef enum {
  AMGX_RC_OK = 0,
  AMGX_RC_BAD_PARAMETERS = 1,
  AMGX_RC_UNKNOWN = 2,
  AMGX_RC_NOT_SUPPORTED_TARGET = 3,
  AMGX_RC_NOT_SUPPORTED_BLOCKSIZE = 4,
  AMGX_RC_CUDA_FAILURE = 5,
  AMGX_RC_THRUST_FAILURE = 6,
  AMGX_RC_NO_MEMORY = 7,
  AMGX_RC_IO_ERROR = 8,
  AMGX_RC_BAD_MODE = 9,
  AMGX_RC_CORE = 10,
  AMGX_RC_PLUGIN = 11,
  AMGX_RC_BAD_CONFIGURATION = 12,
  AMGX_RC_NOT_IMPLEMENTED = 13,
  AMGX_RC_LICENSE_NOT_FOUND = 14,
  AMGX_RC_INTERNAL = 15
} AMGX_RC;

typedef enum {
  AMGX_SOLVE_SUCCESS = 0,
  AMGX_SOLVE_FAILED = 1,
  AMGX_SOLVE_DIVERGED = 2,
  AMGX_SOLVE_NOT_CONVERGED = 3
} AMGX_SOLVE_STATUS;

typedef uintptr_t AMGX_config_handle;
typedef uintptr_t AMGX_resources_handle;
typedef uintptr_t AMGX_matrix_handle;
typedef uintptr_t AMGX_vector_handle;
typedef uintptr_t AMGX_solver_handle;
typedef uintptr_t AMGX_distribution_handle;
typedef uintptr_t AMGX_eigensolver_handle;

typedef enum {
  AMGX_DIST_PARTITION_VECTOR = 0,
  AMGX_DIST_PARTITION_OFFSETS = 1
} AMGX_DIST_PARTITION_INFO;

/* Mode is passed as its name string ("dDDI", "dFFI", ...): a 'd' mode
 * runs on the card, an 'h' mode on the CPU. */

/* receives each line the library prints, with its length */
typedef void (*AMGX_print_callback)(const char *msg, int length);

AMGX_RC AMGX_initialize(void);
AMGX_RC AMGX_finalize(void);
AMGX_RC AMGX_get_api_version(int *major, int *minor);
const char *AMGX_get_error_string(AMGX_RC rc);
AMGX_RC AMGX_register_print_callback(AMGX_print_callback func);

AMGX_RC AMGX_config_create(AMGX_config_handle *cfg, const char *options);
AMGX_RC AMGX_config_create_from_file(AMGX_config_handle *cfg,
                                     const char *path);
AMGX_RC AMGX_config_add_parameters(AMGX_config_handle cfg,
                                   const char *options);
AMGX_RC AMGX_config_destroy(AMGX_config_handle cfg);

AMGX_RC AMGX_resources_create_simple(AMGX_resources_handle *res,
                                     AMGX_config_handle cfg);
AMGX_RC AMGX_resources_destroy(AMGX_resources_handle res);

AMGX_RC AMGX_matrix_create(AMGX_matrix_handle *mtx,
                           AMGX_resources_handle res, const char *mode);
AMGX_RC AMGX_matrix_upload_all(AMGX_matrix_handle mtx, int n, int nnz,
                               int block_dimx, int block_dimy,
                               const int *row_ptrs, const int *col_indices,
                               const void *data, const void *diag_data);
AMGX_RC AMGX_matrix_replace_coefficients(AMGX_matrix_handle mtx, int n,
                                         int nnz, const void *data,
                                         const void *diag_data);
AMGX_RC AMGX_matrix_get_size(AMGX_matrix_handle mtx, int *n,
                             int *block_dimx, int *block_dimy);
AMGX_RC AMGX_matrix_destroy(AMGX_matrix_handle mtx);

AMGX_RC AMGX_vector_create(AMGX_vector_handle *vec,
                           AMGX_resources_handle res, const char *mode);
AMGX_RC AMGX_vector_upload(AMGX_vector_handle vec, int n, int block_dim,
                           const void *data);
AMGX_RC AMGX_vector_download(AMGX_vector_handle vec, void *data);
AMGX_RC AMGX_vector_set_zero(AMGX_vector_handle vec, int n, int block_dim);
AMGX_RC AMGX_vector_bind(AMGX_vector_handle vec, AMGX_matrix_handle mtx);
AMGX_RC AMGX_vector_get_size(AMGX_vector_handle vec, int *n,
                             int *block_dim);
AMGX_RC AMGX_vector_destroy(AMGX_vector_handle vec);

AMGX_RC AMGX_solver_create(AMGX_solver_handle *slv,
                           AMGX_resources_handle res, const char *mode,
                           AMGX_config_handle cfg);
AMGX_RC AMGX_solver_setup(AMGX_solver_handle slv, AMGX_matrix_handle mtx);
AMGX_RC AMGX_solver_solve(AMGX_solver_handle slv, AMGX_vector_handle rhs,
                          AMGX_vector_handle sol);
AMGX_RC AMGX_solver_solve_with_0_initial_guess(AMGX_solver_handle slv,
                                               AMGX_vector_handle rhs,
                                               AMGX_vector_handle sol);
AMGX_RC AMGX_solver_get_status(AMGX_solver_handle slv,
                               AMGX_SOLVE_STATUS *status);
AMGX_RC AMGX_solver_get_iterations_number(AMGX_solver_handle slv, int *n);
AMGX_RC AMGX_solver_get_iteration_residual(AMGX_solver_handle slv, int it,
                                           int idx, double *res);
/* batched solves (the serve layer) */
AMGX_RC AMGX_solver_solve_batch(AMGX_solver_handle slv, int n,
                                const AMGX_matrix_handle *mtx,
                                const AMGX_vector_handle *rhs,
                                AMGX_vector_handle *sol);
AMGX_RC AMGX_solver_destroy(AMGX_solver_handle slv);

/* setup persistence: save/restore a completed solver setup (hierarchy
 * snapshot) — restore skips setup entirely; doc/PERSISTENCE.md */
AMGX_RC AMGX_solver_save(AMGX_solver_handle slv, const char *filename);
AMGX_RC AMGX_solver_load(AMGX_solver_handle slv, const char *filename);

AMGX_RC AMGX_read_system(AMGX_matrix_handle mtx, AMGX_vector_handle rhs,
                         AMGX_vector_handle sol, const char *filename);
AMGX_RC AMGX_write_system(AMGX_matrix_handle mtx, AMGX_vector_handle rhs,
                          AMGX_vector_handle sol, const char *filename);

/* ---- distributed entry points (reference amgx_c.h:235-259,547-594,
 * 439-460, 510-522).  One device in this port: the comm argument of
 * resources_create is ignored, upload_all_global takes the whole
 * system in one call, generate_distributed_poisson_7pt a 1 x 1 x 1
 * process grid; the rest return AMGX_RC_NOT_IMPLEMENTED. ---- */
AMGX_RC AMGX_resources_create(AMGX_resources_handle *res,
                              AMGX_config_handle cfg, void *comm,
                              int device_num, const int *devices);
AMGX_RC AMGX_distribution_create(AMGX_distribution_handle *dist,
                                 AMGX_config_handle cfg);
AMGX_RC AMGX_distribution_destroy(AMGX_distribution_handle dist);
AMGX_RC AMGX_distribution_set_partition_data(
    AMGX_distribution_handle dist, AMGX_DIST_PARTITION_INFO info,
    const void *partition_data);
AMGX_RC AMGX_distribution_set_32bit_colindices(
    AMGX_distribution_handle dist, int use32bit);
AMGX_RC AMGX_matrix_upload_all_global(
    AMGX_matrix_handle mtx, int n_global, int n, int nnz, int block_dimx,
    int block_dimy, const int *row_ptrs, const void *col_indices_global,
    const void *data, const void *diag_data, int allocated_halo_depth,
    int num_import_rings, const int *partition_vector);
AMGX_RC AMGX_matrix_upload_all_global_32(
    AMGX_matrix_handle mtx, int n_global, int n, int nnz, int block_dimx,
    int block_dimy, const int *row_ptrs, const void *col_indices_global,
    const void *data, const void *diag_data, int allocated_halo_depth,
    int num_import_rings, const int *partition_vector);
AMGX_RC AMGX_matrix_upload_distributed(
    AMGX_matrix_handle mtx, int n_global, int n, int nnz, int block_dimx,
    int block_dimy, const int *row_ptrs, const void *col_indices_global,
    const void *data, const void *diag_data,
    AMGX_distribution_handle distribution);
AMGX_RC AMGX_read_system_distributed(
    AMGX_matrix_handle mtx, AMGX_vector_handle rhs, AMGX_vector_handle sol,
    const char *filename, int allocated_halo_depth, int num_partitions,
    const int *partition_sizes, int partition_vector_size,
    const int *partition_vector);
AMGX_RC AMGX_write_system_distributed(
    AMGX_matrix_handle mtx, AMGX_vector_handle rhs, AMGX_vector_handle sol,
    const char *filename, int allocated_halo_depth, int num_partitions,
    const int *partition_sizes, int partition_vector_size,
    const int *partition_vector);
AMGX_RC AMGX_generate_distributed_poisson_7pt(
    AMGX_matrix_handle mtx, AMGX_vector_handle rhs, AMGX_vector_handle sol,
    int allocated_halo_depth, int num_import_rings, int nx, int ny, int nz,
    int px, int py, int pz);

/* ---- one-ring comm maps (reference amgx_c.h:276-284,452-501).
 * read_system_maps_one_ring allocates every out array with malloc;
 * release them with AMGX_free_system_maps_one_ring. ---- */
AMGX_RC AMGX_matrix_comm_from_maps_one_ring(
    AMGX_matrix_handle mtx, int allocated_halo_depth, int num_neighbors,
    const int *neighbors, const int *send_sizes, const int **send_maps,
    const int *recv_sizes, const int **recv_maps);
AMGX_RC AMGX_read_system_maps_one_ring(
    int *n, int *nnz, int *block_dimx, int *block_dimy, int **row_ptrs,
    int **col_indices, void **data, void **diag_data, void **rhs,
    void **sol, int *num_neighbors, int **neighbors, int **send_sizes,
    int ***send_maps, int **recv_sizes, int ***recv_maps,
    AMGX_resources_handle rsc, const char *mode, const char *filename,
    int allocated_halo_depth, int num_partitions,
    const int *partition_sizes, int partition_vector_size,
    const int *partition_vector);
AMGX_RC AMGX_free_system_maps_one_ring(
    int *row_ptrs, int *col_indices, void *data, void *diag_data,
    void *rhs, void *sol, int num_neighbors, int *neighbors,
    int *send_sizes, int **send_maps, int *recv_sizes, int **recv_maps);

/* ---- eigensolver (reference amgx_eig_c.h) ---- */
AMGX_RC AMGX_eigensolver_create(AMGX_eigensolver_handle *ret,
                                AMGX_resources_handle rsc,
                                const char *mode,
                                AMGX_config_handle cfg);
AMGX_RC AMGX_eigensolver_setup(AMGX_eigensolver_handle slv,
                               AMGX_matrix_handle mtx);
AMGX_RC AMGX_eigensolver_pagerank_setup(AMGX_eigensolver_handle slv,
                                        AMGX_vector_handle a);
AMGX_RC AMGX_eigensolver_solve(AMGX_eigensolver_handle slv,
                               AMGX_vector_handle x);
AMGX_RC AMGX_eigensolver_destroy(AMGX_eigensolver_handle slv);

#ifdef __cplusplus
}
#endif

#endif /* AMGX_TPU_TORCH_C_H */
